"""Eq. 9's batched kernel route (one ``feature_stats_many`` call)
against the plain per-class route, in the port and against the
reference (``repro_torch.core.feature_stats.class_preference_vectors``).

Tolerances:
- fp32, the port's two routes on the CPU: 1e-6 absolute (one fp32 sum
  of the same products per column), on a reduced VGG9 and on VGG16's
  100 x 15 table at a sixteenth of its width.
- bf16 (``CNNConfig(dtype=torch.bfloat16)``): the port's kernel route
  equals its plain route within 1e-6 (both sum the same exact products
  of bf16 values in fp32); both are held against the reference's
  ``class_preference_vectors(use_kernel=True)`` on converted params at
  the bf16 tolerance of tests/test_torch_feature_stats.py (atol 0.2,
  rtol 1e-2): the two packages' bf16 forward and backward passes round
  differently.

Torch runs on one intra-op thread here (``_one_thread``): the suite's
xdist workers share the machine's cores, and torch's thread pool then
stalls on every small op (this file's VGG16 case took minutes beside
five other workers, one second alone).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import feature_stats as jfs
from repro.models import cnn as jcnn
from repro_torch import convert
from repro_torch.core import feature_stats as tfs
from repro_torch.kernels import feature_stats as kfs
from repro_torch.models import cnn as tcnn


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrow_vgg16():
    """VGG16's 13 convs and 2 hidden FCs at a sixteenth of the width, on
    100 classes: the Eq. 9 table of vgg16 (100 x 15 reductions) at a size
    the CPU runs in seconds."""
    from repro_torch.configs import vgg16
    plan = tuple(s if s[0] == "p" else ("c", s[1] // 16)
                 for s in tcnn.VGG16_PLAN)
    return dataclasses.replace(vgg16.baseline(), plan=plan, fc_dims=(32, 32))


@pytest.mark.parametrize("name", ["vgg9", "vgg16"])
def test_class_preference_vectors_kernel_route_matches_plain(name):
    """The batched route (one feature_stats_many call) against the plain
    per-class route of the port, on the CPU: no launch, within 1e-6."""
    from repro_torch.configs import vgg9
    cfg = (vgg9.reduced(fed2_groups=0, norm="none") if name == "vgg9"
           else _narrow_vgg16())
    n_taps = 15 if name == "vgg16" else 4
    p = tcnn.init_cnn(torch.Generator().manual_seed(2), cfg)
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(16, 32, 32, 3)).astype(np.float32))
    y = torch.tensor(rng.integers(0, cfg.n_classes, 16))
    before = kfs.feature_stats.launches
    on = tfs.class_preference_vectors(p, cfg, x, y, use_kernel=True)
    assert kfs.feature_stats.launches == before
    off = tfs.class_preference_vectors(p, cfg, x, y, use_kernel=False)
    assert len(on) == len(off) == n_taps
    for a, b in zip(on, off):
        assert a.shape == b.shape and a.shape[1] == cfg.n_classes
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    assert any(bool((b != 0).any()) for b in off)


def test_class_preference_vectors_bf16_kernel_route():
    """A bf16 CNN through Eq. 9's kernel route: its class mask takes the
    activations' dtype, so the masked activations and the bf16 gradient
    buffers share one dtype (the route raised before). Reduced VGG9, 8
    images, against the port's plain route and the reference's kernel
    route (interpret mode) on the same params."""
    from repro_torch.configs import vgg9
    cfg = vgg9.reduced(fed2_groups=0, norm="none", dtype=torch.bfloat16)
    jcfg = dataclasses.replace(
        jcnn.CNNConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)
                          if f.name != "dtype"}), dtype=jnp.bfloat16)
    init = jcnn.init_cnn(jax.random.PRNGKey(3), jcfg)        # bf16 leaves
    # bf16 -> fp32 -> bf16 is exact: the port holds the same values
    p = convert.to_port(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), init), dtype=torch.bfloat16)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    y = (np.arange(8) % 10).astype(np.int32)
    xt, yt = torch.tensor(x).to(torch.bfloat16), torch.tensor(y)
    before = kfs.feature_stats.launches
    on = tfs.class_preference_vectors(p, cfg, xt, yt, use_kernel=True)
    assert kfs.feature_stats.launches == before   # CPU: plain version
    off = tfs.class_preference_vectors(p, cfg, xt, yt, use_kernel=False)
    want = jfs.class_preference_vectors(
        init, jcfg, jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(y),
        use_kernel=True)
    assert len(on) == len(off) == len(want) == 4
    for a, b, w in zip(on, off, want):
        assert a.dtype == b.dtype == torch.float32
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
        w = np.asarray(w, np.float32)
        for got in (a, b):
            np.testing.assert_allclose(got.numpy(), w, atol=0.2, rtol=1e-2)
    assert any(bool((b != 0).any()) for b in off)
