"""The capability matrix: one source of truth for method eligibility.

Every optional federation feature (capacity tiers, buffered-async
events, robust fusion, uplink codecs, the bf16 local phase, the fused
``local_step`` kernel, non-structural alignment strategies and one-shot
fusion) is gated per method by a ``FedMethod`` capability flag, and the
flags are read in exactly one place:

- ``supports(method, feature)``: the only code outside fl/methods.py
  (where the flags are defined) that reads the derived eligibility
  flags (``tier_fusion``/``async_eligible``/``robust_fusion``/
  ``uplink_codec``/``mixed_precision``/``fused_local_step``);
  tests/test_torch_compat.py holds every other module of the port to it.
- ``check_<feature>_support(method, ...)``: the targeted refusals, with
  the JAX package's messages word for word.
- ``validate(cfg, method)``: the single eligibility entry point.
  ``FLConfig.__post_init__``, ``ScenarioSpec.__post_init__`` and
  ``make_round_engine`` all call it; it reads the knobs off ``cfg``
  duck-typed (``tiers``/``mode``/``robust``/``codec``/``compute_dtype``/
  ``alignment``), so configs, scenario specs and direct engine drives
  hit identical refusals.
- ``capability_matrix()`` / ``capability_table()``: what
  ``launch/train.py --list-capabilities`` prints.
"""
from __future__ import annotations

from repro_torch.fl.methods import FedMethod

# feature -> (governing FedMethod flag, predicate). The predicate is the
# only read of each raw flag outside fl/methods.py.
_FEATURES = {
    "tiers": ("tier_fusion", lambda m: m.tier_fusion),
    "async": ("async_eligible", lambda m: m.async_eligible),
    "robust": ("robust_fusion", lambda m: m.robust_fusion),
    "codec": ("uplink_codec", lambda m: m.uplink_codec),
    "bf16": ("mixed_precision", lambda m: m.mixed_precision),
    "kernel": ("fused_local_step", lambda m: m.fused_local_step),
    # non-structural alignment (pan/none) builds a plain net, so a
    # method whose fuse is defined over structure groups refuses;
    # "grouped" (the method's own declaration) is always allowed
    "alignment": ("uses_groups", lambda m: not m.uses_groups),
    # one-shot fusion fuses exactly once: per-client state that corrects
    # drift across rounds has nothing to correct
    "one_shot": ("client_stateful", lambda m: not m.client_stateful),
}

FEATURES = tuple(_FEATURES)


def supports(method: FedMethod, feature: str) -> bool:
    """Whether ``method`` carries ``feature``: the single read of the
    raw capability flags."""
    try:
        _, pred = _FEATURES[feature]
    except KeyError:
        raise ValueError(
            f"unknown capability feature {feature!r}; features: "
            f"{', '.join(FEATURES)}") from None
    return bool(pred(method))


def flag_name(feature: str) -> str:
    """The ``FedMethod`` flag governing ``feature``."""
    if feature not in _FEATURES:
        raise ValueError(
            f"unknown capability feature {feature!r}; features: "
            f"{', '.join(FEATURES)}")
    return _FEATURES[feature][0]


def capability_matrix() -> dict[str, dict[str, bool]]:
    """{method name: {feature: supported}} over the method registry."""
    from repro_torch.fl import methods as methods_lib
    return {name: {f: supports(methods_lib.get(name), f)
                   for f in FEATURES}
            for name in methods_lib.available()}


def capability_table() -> str:
    """The method x feature support table as one markdown string (what
    ``launch/train.py --list-capabilities`` prints)."""
    header = "| method | " + " | ".join(FEATURES) + " |"
    sep = "|---" * (len(FEATURES) + 1) + "|"
    rows = [header, sep]
    for name, feats in capability_matrix().items():
        cells = " | ".join("yes" if feats[f] else "—" for f in FEATURES)
        rows.append(f"| `{name}` | {cells} |")
    return "\n".join(rows)


# ---------------------------------------------------------------------------
# The targeted refusals (the JAX package's messages, word for word)
# ---------------------------------------------------------------------------


def check_tier_support(method, mix=None) -> None:
    """Raise unless ``method`` declares ``tier_fusion``. A trivial mix
    (one width-1.0 tier) is always allowed."""
    if mix is not None and len(mix) == 1 and mix[0][0] == 1.0:
        return
    if not supports(method, "tiers"):
        raise ValueError(
            f"{method.name} does not support capacity tiers "
            "(FedMethod.tier_fusion): tiered fusion needs a device fuse "
            "affine in the weighted client mean and no per-client state"
            + (" — host matching is not defined across sub-model widths"
               if method.host_fusion else
               " — its server step reads per-client cohort state"
               if method.client_stateful or not method.cohort_tiling
               else ""))


def check_async_support(method: FedMethod, *,
                        presence_weighted: bool = False) -> None:
    """Raise unless ``method`` declares ``async_eligible``, and always
    for presence-weighted group fusion."""
    if not supports(method, "async"):
        raise ValueError(
            f"{method.name} does not support buffered-async federation "
            "(FedMethod.async_eligible): a fusion event fuses "
            "staleness-discounted updates that trained from MIXED global "
            "versions, which needs a device fuse affine in the weighted "
            "client mean and no per-client state"
            + (" — host matched averaging has no staleness-weighted form"
               if method.host_fusion else
               " — its server step reads the participating cohort's "
               "per-client state, which a buffer of mixed-version "
               "arrivals cannot provide"
               if method.client_stateful or not method.cohort_tiling
               else "") + "; run mode='sync' instead")
    if presence_weighted:
        raise ValueError(
            "presence-weighted group fusion does not support "
            "buffered-async federation: each fusion event renormalizes "
            "group columns over its buffer_k arrivals, and a group held "
            "by no arrival falls back to the uniform column — either "
            "biases Eq. 19 exactly as tiled sync rounds would "
            "(fl/runtime.py); drop class_counts/group_spec or run "
            "mode='sync'")


def check_robust_support(method: FedMethod, rule=None) -> None:
    """Raise unless ``method`` can carry robust fusion."""
    if not supports(method, "robust"):
        what = rule.describe() if rule is not None else "robust fusion"
        raise ValueError(
            f"{method.name} does not support {what} "
            "(FedMethod.robust_fusion): robust rules replace or wrap the "
            "cross-client reduction inside core/fusion.py, which "
            "host-fusion methods never run — their round ends at the "
            "stacked params and fuses on the host (matching has no "
            "coordinate-reduction form)")


def check_codec_support(method: FedMethod, codec=None, robust=None) -> None:
    """Raise unless ``method`` (and the active robust rule) can carry the
    codec."""
    if not supports(method, "codec"):
        what = codec.describe() if codec is not None else "an uplink codec"
        raise ValueError(
            f"{method.name} does not support {what} "
            "(FedMethod.uplink_codec): decode-then-fuse reconstructs the "
            "client deltas on the device right before an affine fuse — "
            "host-fusion methods never fuse on device, and "
            "client-stateful methods correct drift off the exact local "
            "params, which a lossy uplink would silently bias")
    if (codec is not None and robust is not None and robust.reduces
            and not codec.exact):
        raise ValueError(
            f"robust rule {robust.describe()!r} refuses lossy codec "
            f"{codec.describe()!r}: the reducing rules' breakdown "
            "guarantee is proven for the updates the clients sent, not "
            "for quantized reconstructions — use the exact 'identity' "
            "codec or drop the robust rule")


def check_bf16_support(method: FedMethod) -> None:
    """Raise unless ``method`` may run its local phase in bf16."""
    if not supports(method, "bf16"):
        raise ValueError(
            f"{method.name} does not support a bfloat16 local phase "
            "(FedMethod.mixed_precision): the downcast happens at the "
            "round boundary, so the method must be client-stateless and "
            "fuse on the device where the fp32 accumulators live")


def check_alignment_support(method: FedMethod, strategy) -> None:
    """Raise unless ``method`` can run under ``strategy`` (an
    ``AlignmentStrategy`` of fl/alignment.py): ``grouped`` is always
    allowed; pan/none build a plain net, which a fuse defined over
    structure groups cannot use."""
    if strategy.structural:
        return
    if not supports(method, "alignment"):
        raise ValueError(
            f"{method.name} does not support alignment="
            f"'{strategy.name}' (FedMethod.uses_groups): its fuse is "
            "defined over Fed2 structure groups (paired averaging, "
            "Eq. 19), and a non-structural strategy builds a plain net "
            "with no group axes to pair — run alignment='grouped', or "
            "pick a coordinate method (fedavg/fedprox/...)")


def check_one_shot_support(method: FedMethod) -> None:
    """Raise unless ``method`` can fuse exactly once (mode='one_shot')."""
    if not supports(method, "one_shot"):
        raise ValueError(
            f"{method.name} does not support one-shot fusion "
            "(FedMethod.client_stateful): its per-client state corrects "
            "drift ACROSS rounds, and with exactly one fusion there is "
            "no later round to correct — run mode='sync'")


# ---------------------------------------------------------------------------
# The single eligibility entry point
# ---------------------------------------------------------------------------


def validate(cfg, method: FedMethod) -> None:
    """Run every applicable eligibility refusal for ``cfg``'s knobs
    against ``method``. Knobs are read duck-typed (``getattr`` with the
    off-default), so a missing knob means "feature off". Value parsing
    stays with the callers; this owns method eligibility, plus the
    robust x codec composition rule."""
    tiers = getattr(cfg, "tiers", None)
    if tiers:
        from repro_torch.fl import capacity as capacity_lib
        check_tier_support(method, capacity_lib.parse_tiers(tiers))
    mode = getattr(cfg, "mode", "sync")
    if mode == "async":
        check_async_support(method)
    elif mode == "one_shot":
        check_one_shot_support(method)
    rule = None
    if getattr(cfg, "robust", None):
        from repro_torch.fl import robust as robust_lib
        rule = robust_lib.parse_robust(cfg.robust)
        check_robust_support(method, rule)
        if not rule.active:
            rule = None
    if getattr(cfg, "codec", None):
        from repro_torch.fl import codec as codec_lib
        check_codec_support(method, codec_lib.parse_codec(cfg.codec), rule)
    if getattr(cfg, "compute_dtype", "float32") not in (None, "",
                                                        "float32"):
        check_bf16_support(method)
    align = getattr(cfg, "alignment", "grouped")
    if align:
        from repro_torch.fl import alignment as alignment_lib
        check_alignment_support(method, alignment_lib.get(align))
