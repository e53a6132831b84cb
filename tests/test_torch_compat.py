"""The port's capability matrix (``repro_torch.fl.compat``) against the
reference's (``repro.fl.compat``).

- ``capability_matrix()`` and ``capability_table()`` are equal for all
  8 methods;
- every ``check_*_support`` refusal raises the reference's message, word
  for word, for every method;
- ``FLConfig`` constructs iff the feature is supported (capacity tiers
  and mode='async' included), and a refusal carries the reference's
  message; the CLI's ``--store mmap --chunk-size 2`` runs for sync and
  async runs and gives the ``--store memory`` history to the bit;
- ``validate`` fires from ``FLConfig``, ``ScenarioSpec`` and
  ``make_round_engine``;
- no module of the port outside fl/compat.py and fl/methods.py reads a
  derived eligibility flag (the reference's AST pin,
  tests/test_compat.py, applied to ``src/repro_torch``).
"""
import ast
import dataclasses
import pathlib

import pytest

from repro.fl import alignment as jalign
from repro.fl import codec as jcodec
from repro.fl import compat as jcompat
from repro.fl import methods as jmethods
from repro.fl import robust as jrobust
from repro.fl import runtime as jruntime
from repro_torch.fl import alignment as talign
from repro_torch.fl import codec as tcodec
from repro_torch.fl import compat as tcompat
from repro_torch.fl import methods as tmethods
from repro_torch.fl import robust as trobust
from repro_torch.fl import runtime as truntime

ROOT = pathlib.Path(__file__).resolve().parents[1]
METHODS = tmethods.available()

# the smallest config that turns each ported, refusing feature on
FEATURE_KW = {
    "tiers": dict(tiers="1.0x2,0.5x1"),
    "async": dict(mode="async"),
    "robust": dict(robust="trimmed_mean(0.25)"),
    "codec": dict(codec="int8"),
    "bf16": dict(compute_dtype="bfloat16"),
    "alignment": dict(alignment="pan"),
    "one_shot": dict(mode="one_shot"),
}


def _cfg(mod, method, **kw):
    return mod.FLConfig(population=3, rounds=1, local_epochs=1,
                        steps_per_epoch=1, batch_size=4, lr=0.1,
                        method=method, seed=0, **kw)


def _message(fn, *args, **kw):
    """The ValueError message of ``fn(*args, **kw)``, or None."""
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


def test_registries_and_features_match():
    assert METHODS == jmethods.available()
    assert tcompat.FEATURES == jcompat.FEATURES
    for f in tcompat.FEATURES:
        assert tcompat.flag_name(f) == jcompat.flag_name(f)


def test_capability_matrix_equals_reference():
    assert tcompat.capability_matrix() == jcompat.capability_matrix()
    assert tcompat.capability_table() == jcompat.capability_table()


@pytest.mark.parametrize("method", METHODS)
def test_check_messages_match_reference(method):
    t, j = tmethods.get(method), jmethods.get(method)
    calls = [
        ("check_tier_support", (), {}),
        ("check_tier_support", ([(1.0, 3)],), {}),
        ("check_async_support", (), {}),
        ("check_async_support", (), {"presence_weighted": True}),
        ("check_bf16_support", (), {}),
        ("check_one_shot_support", (), {}),
    ]
    for name, args, kw in calls:
        got = _message(getattr(tcompat, name), t, *args, **kw)
        want = _message(getattr(jcompat, name), j, *args, **kw)
        assert got == want, (name, got, want)
    for spec in ("trimmed_mean(0.25)", "norm_clip(10)", None):
        got = _message(tcompat.check_robust_support, t,
                       spec and trobust.parse_robust(spec))
        want = _message(jcompat.check_robust_support, j,
                        spec and jrobust.parse_robust(spec))
        assert got == want
    for cspec, rspec in (("int8", None), ("topk(0.05)", "trimmed_mean(0.2)"),
                         ("identity", "coordinate_median"),
                         ("int8", "norm_clip(1)"), (None, None)):
        got = _message(tcompat.check_codec_support, t,
                       cspec and tcodec.parse_codec(cspec),
                       rspec and trobust.parse_robust(rspec))
        want = _message(jcompat.check_codec_support, j,
                        cspec and jcodec.parse_codec(cspec),
                        rspec and jrobust.parse_robust(rspec))
        assert got == want
    for strat in jalign.available():
        got = _message(tcompat.check_alignment_support, t, talign.get(strat))
        want = _message(jcompat.check_alignment_support, j,
                        jalign.get(strat))
        assert got == want


@pytest.mark.parametrize("feature", sorted(FEATURE_KW))
@pytest.mark.parametrize("method", METHODS)
def test_config_constructs_iff_supported(method, feature):
    kw = FEATURE_KW[feature]
    got = _message(_cfg, truntime, method, **kw)
    want = _message(_cfg, jruntime, method, **kw)
    assert got == want
    assert (got is None) == tcompat.supports(tmethods.get(method), feature)
    if got is not None:
        assert tcompat.flag_name(feature) in got


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_unported_features_are_refused(mode):
    """The JAX CLI's --store mmap (with --chunk-size) runs on the CPU in
    both modes and gives the --store memory run to the bit (history and
    final params)."""
    import numpy as np
    import torch

    from repro_torch.launch import train
    from repro_torch.models.module import tree_leaves
    assert _cfg(jruntime, "fedavg", store="mmap").store == "mmap"
    argv = ["--fed-mode", mode, "--reduced", "--rounds", "2", "--nodes",
            "4", "--cohort-size", "2", "--sampler", "uniform",
            "--steps-per-epoch", "2", "--batch", "8", "--train-size", "200",
            "--device", "cpu"]
    if mode == "async":
        argv += ["--buffer-k", "1", "--latency", "pareto(1.5)"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mem = train.main(argv + ["--store", "memory"])
        mm = train.main(argv + ["--store", "mmap", "--chunk-size", "2"])
    finally:
        torch.set_num_threads(n)
    for key in ("round", "acc", "per_class_acc", "participants"):
        assert len(mem[key]) == len(mm[key]) == 2, key
        for a, b in zip(mem[key], mm[key]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tree_leaves(mem["final_params"]),
                    tree_leaves(mm["final_params"])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(attack_fraction=0.2),
    dict(attack="sign_flip", attack_fraction=0.0),
    dict(attack="sign_flip", attack_fraction=3),
    dict(attack="teleport", attack_fraction=0.5),
    dict(robust="median"),
    dict(robust="trimmed_mean(0.5)"),
    dict(codec="zip"),
    dict(codec="topk(2)"),
    dict(compute_dtype="float16"),
    dict(local_unroll=0),
    dict(mode="eventual"),
    dict(alignment="diagonal"),
    dict(tiers="1.0x2"),
    dict(tiers="1.0x3", mode="async"),
    dict(mode="async", staleness="linear"),
    dict(buffer_k=3),
    dict(robust="trimmed_mean(0.25)", codec="topk(0.1)"),
])
def test_config_refusals_match_reference(kw):
    got = _message(_cfg, truntime, "fedavg", **kw)
    want = _message(_cfg, jruntime, "fedavg", **kw)
    assert got is not None and got == want


def test_validate_fires_from_scenario_spec_and_engine():
    from repro_torch.configs import vgg9
    from repro_torch.fl import scenarios as tscen
    from repro_torch.fl.engine import make_round_engine
    with pytest.raises(ValueError, match="FedMethod.uses_groups"):
        tscen.get("nxc2_fed2").override(alignment="pan")
    with pytest.raises(ValueError, match="FedMethod.client_stateful"):
        tscen.get("nxc2_fedavg").override(method="scaffold",
                                          mode="one_shot")
    # a config smuggled past __post_init__ still refuses at the engine
    cfg = _cfg(truntime, "scaffold")
    object.__setattr__(cfg, "compute_dtype", "bfloat16")
    task = truntime.cnn_task(vgg9.reduced(n_classes=4, fed2_groups=0,
                                          norm="none"))
    import torch
    params = task.init_fn(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="mixed_precision"):
        make_round_engine(task, cfg, params, device="cpu")


def test_fl_config_fields_cover_the_reference_knobs():
    """Every feature knob of the reference's FLConfig this slice ports
    exists in the port's with the same default."""
    t = {f.name: f.default for f in dataclasses.fields(truntime.FLConfig)}
    j = {f.name: f.default for f in dataclasses.fields(jruntime.FLConfig)}
    for k in ("mode", "tiers", "attack", "attack_fraction", "robust",
              "compute_dtype", "codec", "local_unroll", "alignment",
              "buffer_k", "staleness", "store", "chunk_size"):
        assert t[k] == j[k], k


DERIVED_FLAGS = frozenset({
    "tier_fusion", "async_eligible", "robust_fusion", "uplink_codec",
    "mixed_precision", "fused_local_step",
})
ALLOWED = {"fl/compat.py", "fl/methods.py"}


def test_derived_flags_read_only_in_compat():
    offenders = []
    src = ROOT / "src" / "repro_torch"
    for py in src.rglob("*.py"):
        rel = py.relative_to(src).as_posix()
        if rel in ALLOWED:
            continue
        for node in ast.walk(ast.parse(py.read_text())):
            if (isinstance(node, ast.Attribute)
                    and node.attr in DERIVED_FLAGS):
                offenders.append((rel, node.lineno, node.attr))
    assert not offenders, offenders
