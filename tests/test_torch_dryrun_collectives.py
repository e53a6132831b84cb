"""The model dry-run's ``collectives`` (``launch/dryrun.py``): rank 0's
program of the sharded decode step on a dry mesh, run once on meta, for
the ``decode_32k`` records of llama3.2-1b and mamba2-1.3b (± fed2) at
16x16 and 2x16x16, against the counts derived from the program's code
(PERF.md §6, PR 37), with the records' bytes unchanged; the records the
sharded program does not cover keep ``null``.

The derivation, a rank's rows B_l = 128 / 16 = 8 (4 at 2x16x16, the
pod and data axes folded into one batch line of 32), bf16 activations,
d = 2048, 16 model ranks:
- both archs: the vocab-parallel embedding's all-reduce, (B_l, 1, d)
  bf16; the logits' all-gather, (B_l, 1, V/16) bf16 a rank, 16 x that
  as result (llama V = 128,256: 8,016 columns; mamba V = 50,304: 3,144;
  Fed2's G x V/(G·16) is the same count);
- llama, a layer (16): one all-gather of the token's q, k and v
  columns, (B_l, 2·64 + 2·32) bf16, result x 16; the fp32 partial
  scores' all-reduce, (B_l, 32 heads, 32,768 slots) x 4 B; the
  all-to-all of the outputs, (16, B_l, 2 heads, 4 dims) bf16; the
  row-parallel all-reduces of wo and the FFN's down product, (B_l, 1,
  d) bf16 each;
- mamba, a layer (48): the all-gather of the conv's 272 channels,
  (B_l, 272) bf16, result x 16; the gated norm's fp32 sum of squares,
  (B_l, 1, 1); out_proj's all-reduce, (B_l, 1, d) bf16.
"""
import pytest

from repro_torch.configs.shapes import INPUT_SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.collectives import staged_bytes
from repro_torch.launch.mesh import make_production_mesh

MESHES = {"16x16": False, "2x16x16": True}
# (all-reduce count, bytes), (all-gather count, bytes), (all-to-all
# count, bytes) of one decode step at 16x16; 2x16x16 halves every byte
PREDICTED = {
    "llama3.2-1b": ((49, 537_952_256), (17, 2_838_528), (16, 32_768)),
    "mamba2-1.3b": ((97, 1_607_168), (49, 4_147_200), (0, 0)),
}
# the parent's argument_bytes of the same records, unchanged
ARGUMENT_BYTES = {
    ("llama3.2-1b", False, "16x16"): 726_405_156,
    ("llama3.2-1b", False, "2x16x16"): 457_969_684,
    ("llama3.2-1b", True, "16x16"): 675_655_716,
    ("llama3.2-1b", True, "2x16x16"): 407_220_244,
    ("mamba2-1.3b", False, "16x16"): 244_198_948,
    ("mamba2-1.3b", False, "2x16x16"): 218_719_764,
    ("mamba2-1.3b", True, "16x16"): 232_930_852,
    ("mamba2-1.3b", True, "2x16x16"): 207_451_668,
}
# each (arch, shape, fed2, swa)'s global meta pass, run once for both
# meshes, as run_one keeps them
_PASSES = {}


def _derived(arch, dim: int, d: int = 2048) -> dict:
    """``PREDICTED``'s numbers from the formulas of the module
    docstring, for a rank of ``dim`` batch rows."""
    emb = dim * d * 2
    if arch == "llama3.2-1b":
        layer_reduce = dim * 32 * 32768 * 4 + 2 * dim * d * 2
        return {"all-reduce": (1 + 16 * 3, emb + 16 * layer_reduce),
                "all-gather": (17, 16 * 16 * dim * 192 * 2
                               + 16 * dim * 8016 * 2),
                "all-to-all": (16, 16 * 16 * dim * 2 * 4 * 2)}
    return {"all-reduce": (1 + 48 * 2, emb + 48 * (dim * 4 + dim * d * 2)),
            "all-gather": (49, 48 * 16 * dim * 272 * 2 + 16 * dim * 3144 * 2),
            "all-to-all": (0, 0)}


def test_the_prediction_is_the_derivation():
    for arch, (ar, ag, a2a) in PREDICTED.items():
        assert _derived(arch, 8) == {"all-reduce": ar, "all-gather": ag,
                                     "all-to-all": a2a}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("fed2", [False, True], ids=["plain", "fed2"])
@pytest.mark.parametrize("arch", PREDICTED)
def test_decode_records_carry_the_predicted_collectives(arch, fed2, mesh,
                                                        tmp_path):
    rec = dryrun.run_one(arch, "decode_32k",
                         mesh=make_production_mesh(multi_pod=MESHES[mesh]),
                         fed2=fed2, outdir=str(tmp_path), verbose=False,
                         passes=_PASSES)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["memory"]["argument_bytes"] == ARGUMENT_BYTES[
        (arch, fed2, mesh)]
    coll = rec["collectives"]
    assert list(coll) == ["all-reduce", "all-gather", "reduce-scatter",
                          "all-to-all", "collective-permute"]
    half = 2 if MESHES[mesh] else 1
    for kind, (count, nbytes) in zip(("all-reduce", "all-gather",
                                      "all-to-all"), PREDICTED[arch]):
        assert coll[kind] == {"count": count, "bytes": nbytes // half}, kind
    for kind in ("reduce-scatter", "collective-permute"):
        assert coll[kind] == {"bytes": 0, "count": 0}
    # gloo's host copies: each tensor down, each result back
    ar, ag = coll["all-reduce"]["bytes"], coll["all-gather"]["bytes"]
    assert rec["collectives_staged"]["all-reduce"] == staged_bytes(ar, ar)
    assert rec["collectives_staged"]["all-gather"] == staged_bytes(
        ag // 16, ag)
    assert rec["rank_program_s"] >= 0
    assert "mamba2-1.3b" in rec["notes"]["collectives"]


def _no_meta_pass(step):
    """A stand-in for the global meta pass (the train step's takes
    minutes): outputs of the declared shapes, no FLOPs."""
    import torch
    loss = torch.empty((), device="meta")
    out = {3: lambda: (step.args[0], step.args[1], loss),    # train
           2: lambda: (torch.empty((step.args[2].shape[0], 1, 1),
                                   device="meta"), step.args[1]),  # decode
           1: lambda: loss}[len(step.out_specs)]()
    return 0, out, 0.0


@pytest.mark.parametrize("arch,shape", [("llama3.2-1b", "train_4k"),
                                        ("mamba2-1.3b", "train_4k"),
                                        ("qwen2-7b", "decode_32k"),
                                        ("zamba2-2.7b", "decode_32k")])
def test_records_the_sharded_program_does_not_cover_keep_null(
        arch, shape, tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "meta_pass", _no_meta_pass)
    rec = dryrun.run_one(arch, shape, mesh=make_production_mesh(),
                         fed2=False, outdir=str(tmp_path), verbose=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["collectives"] is None and "rank_program_s" not in rec
    assert not dryrun.covered(arch, dryrun.config_of(arch),
                              INPUT_SHAPES[shape], make_production_mesh())
