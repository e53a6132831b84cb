"""Beyond-paper example: FEDERATED LM fine-tuning with Fed2 vocab-cluster
groups (the reference's DESIGN.md §3). Clients hold disjoint token
*domains* (the LM analog of non-IID classes); the Fed2-adapted
transformer isolates each domain's features in its own FFN/unembed
group, and fusion pairs groups by vocab cluster. The port of the
reference's ``examples/llm_federated_finetune.py``, with its flags and
defaults.

  PYTHONPATH=src python -m repro_torch.examples.llm_federated_finetune
  PYTHONPATH=src python -m repro_torch.examples.llm_federated_finetune \\
      --rounds 1 --device cpu

The reduced config with ``with_fed2(groups=4, decouple=1)`` federates
through ``fl/runtime.lm_task``: on the card each round fuses with one
``paired_fusion`` launch, and its eval unembeds through one
``grouped_matmul`` launch (the block-diagonal unembedding).
"""
from __future__ import annotations

import argparse

import numpy as np

N_DOMAINS = 4


def model_config(arch: str):
    from repro_torch.configs import get_config
    from repro_torch.configs.common import with_fed2
    return with_fed2(get_config(arch, reduced=True), groups=4, decouple=1)


def held_out_batches(cfg, seq: int) -> list:
    """The eval set: 64 held-out sequences of the same domains."""
    from repro_torch.data.synthetic import make_token_dataset
    test_toks, _ = make_token_dataset(64, seq + 1, cfg.vocab,
                                      n_domains=N_DOMAINS, seed=7)
    return [{"tokens": test_toks[:, :-1], "labels": test_toks[:, 1:],
             "mask": np.ones((64, seq), np.float32)}]


def run_llm_federated_finetune(*, arch: str = "llama3.2-1b",
                               rounds: int = 4, nodes: int = 4,
                               cohort_size: int | None = None,
                               sampler: str = "full", seq: int = 64,
                               methods: str = "fedavg,fed2", device=None,
                               init_params=None, log=print) -> dict:
    """Each federated method's ``run_federated`` history, by name;
    host-fusion methods are skipped (logged), as the reference's.
    ``init_params(cfg)`` gives the initial params tree (e.g. the
    reference's ``PRNGKey(0)`` init through ``repro_torch.convert``);
    None draws one from the run's seed."""
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.fl import methods as methods_lib
    from repro_torch.fl.runtime import (FLConfig, lm_task, resolve_device,
                                        run_federated)
    device = resolve_device(device)
    cfg = model_config(arch)
    toks, domains = make_token_dataset(800, seq + 1, cfg.vocab,
                                       n_domains=N_DOMAINS, seed=0)
    # non-IID: client j holds only domain j's sequences
    parts = [np.flatnonzero(domains == j) for j in range(nodes)]

    def get_batch(sel):
        sl = toks[sel]
        return {"tokens": sl[:, :-1], "labels": sl[:, 1:],
                "mask": np.ones((len(sel), seq), np.float32)}

    test_batches = held_out_batches(cfg, seq)
    chosen = (methods_lib.available() if methods == "all"
              else methods.split(","))
    results = {}
    for method in chosen:
        if methods_lib.get(method).host_fusion:
            if log:
                log(f"{method}: skipped (host matched averaging is defined "
                    "for non-grouped CNNs; no LM analog)")
            continue
        fl = FLConfig(population=nodes, cohort_size=cohort_size,
                      sampler=sampler, rounds=rounds, local_epochs=1,
                      steps_per_epoch=4, batch_size=8, lr=0.01,
                      momentum=0.9, method=method, seed=0)
        h = run_federated(
            lm_task(cfg), fl, parts, get_batch, test_batches, log=None,
            device=device,
            init_params=None if init_params is None else init_params(cfg))
        results[method] = h
        if log:
            log(f"{method}: next-token acc per round: "
                f"{['%.3f' % a for a in h['acc']]}")
    return results


def main(argv=None):
    from repro_torch.fl import methods as methods_lib
    from repro_torch.fl import population as population_lib
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--nodes", type=int, default=4,
                    help="logical client population (one token domain "
                         "per client)")
    ap.add_argument("--cohort-size", type=int, default=None,
                    help="participants per round; default = all nodes")
    ap.add_argument("--sampler", default="full",
                    choices=list(population_lib.available()))
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--methods", default="fedavg,fed2",
                    help="comma list from "
                         f"{','.join(methods_lib.available())}, or 'all' "
                         "(host-fusion methods need a CNN task and are "
                         "skipped for the LM)")
    ap.add_argument("--device", default=None,
                    help="torch device; default = the CUDA card (fails "
                         "without one), 'cpu' to run on the CPU")
    args = ap.parse_args(argv)
    return run_llm_federated_finetune(
        arch=args.arch, rounds=args.rounds, nodes=args.nodes,
        cohort_size=args.cohort_size, sampler=args.sampler, seq=args.seq,
        methods=args.methods, device=args.device)


if __name__ == "__main__":
    main()
