"""The port's LPIPS (``gsvc_tpu_torch/metrics/lpips.py``) against the JAX
package's on the same inputs.

* ``proxy_lpips_weights`` draws the same PCG64 stream in the same order,
  so its weights equal JAX's bit for bit;
* ``lpips`` equals JAX's at rtol 1e-5 / atol 1e-7 on seeded 64x48 pairs,
  with the proxy weights and with full-width VGG16 weights in the
  exporter's npz schema (tests/test_lpips_npz.py): the convolutions are
  the same float32 sums taken in another order;
* the port holds JAX's pinned golden value (tests/test_lpips.py) at
  rel 1e-3, the golden's own headroom.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsvc_tpu.metrics import lpips as jlp
from gsvc_tpu_torch.metrics import lpips as plp
from tests.test_lpips_npz import _make_npz

RTOL, ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module")
def npz_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz"
    _make_npz(path, seed=1)
    return str(path)


def _pairs():
    rng = np.random.default_rng(11)
    a = rng.random((48, 64, 3)).astype(np.float32)
    near = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    far = rng.random((48, 64, 3)).astype(np.float32)
    return [(a, near), (a, far), (near, far)]


def test_proxy_weights_equal_jax_bit_for_bit():
    got = plp.proxy_lpips_weights()
    want = jlp.proxy_lpips_weights()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the sentinel path gives the same weights, on the device asked for
    for k, v in plp.load_lpips_weights("proxy", device="cpu").items():
        assert torch.equal(v, got[k])


@pytest.mark.parametrize("kind", ["proxy", "npz"])
def test_lpips_matches_jax(kind, npz_path):
    path = "proxy" if kind == "proxy" else npz_path
    wp = plp.load_lpips_weights(path)
    wj = jlp.load_lpips_weights(path)
    if kind == "npz":
        assert wp["features.28.weight"].shape == (512, 512, 3, 3)
    for a, b in _pairs():
        got = plp.lpips(wp, torch.from_numpy(a), torch.from_numpy(b))
        want = float(jlp.lpips(wj, jnp.asarray(a), jnp.asarray(b)))
        assert got.dim() == 0 and got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=ATOL)
    assert float(plp.lpips(wp, a, a)) == pytest.approx(0.0, abs=1e-6)


def test_lpips_holds_jax_golden():
    h = w = 32
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    a = np.stack([np.sin(xx / 5.0), np.cos(yy / 7.0),
                  np.sin((xx + yy) / 9.0)], -1).astype(np.float32) * 0.5 \
        + 0.5
    b = np.roll(a, 3, axis=1) * 0.9
    d_ab = float(plp.lpips(plp.proxy_lpips_weights(), a, b))
    golden = 0.013052504509687424
    assert abs(d_ab - golden) / golden < 1e-3, d_ab


def test_lpips_without_weights_raises():
    a = np.zeros((16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match="pretrained"):
        plp.lpips(None, a, a)


def test_lpips_leaves_the_process_tf32_flag_alone():
    before = torch.backends.cudnn.allow_tf32
    plp.lpips(plp.proxy_lpips_weights(), np.zeros((16, 16, 3), np.float32),
              np.ones((16, 16, 3), np.float32))
    assert torch.backends.cudnn.allow_tf32 == before
