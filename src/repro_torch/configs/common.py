"""Shared helpers for the LM configs: Fed2's structure adaptation and
the storage dtypes of full and reduced configs."""
import dataclasses

import torch


def with_fed2(cfg, groups: int = 8, decouple: int | None = None):
    """Apply Fed2 structure adaptation to an LM config: the last
    ``decouple`` blocks get block-diagonal FFNs, the unembedding becomes
    block-diagonal over vocab clusters (the reference's DESIGN.md §3)."""
    if decouple is None:
        decouple = max(1, min(6, cfg.n_layers // 4))
    if cfg.family in ("ssm", "hybrid"):
        # channel grouping for SSM mixers is carried by Fed2 fusion group
        # maps; block-diagonal unembed still applies.
        decouple = 0
    if cfg.family == "moe":
        # experts ARE the isolated structure groups; fusion pairs experts
        # by logit signature, FFN stays expert-partitioned.
        decouple = 0
    if decouple > 0 and (cfg.d_model % groups or cfg.d_ff % groups):
        raise ValueError(f"{cfg.arch_id}: d_model {cfg.d_model} and d_ff "
                         f"{cfg.d_ff} must divide into {groups} groups")
    return dataclasses.replace(cfg, fed2_groups=groups,
                               fed2_decouple=decouple)


FULL_DTYPE = torch.bfloat16
REDUCED_DTYPE = torch.float32
