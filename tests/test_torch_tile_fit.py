"""A four-phase fit at a frame width that is not a multiple of ``tile_w``
against the JAX package's fitter: every training step renders through
the single-view composite (kernels B5f/B5b through their plain PyTorch
versions here; JAX: ``pallas_tile_composite`` in Pallas interpret mode).
Held as tests/test_torch_train.py holds the tile-aligned fit, with the
losses to rtol 1e-4.
"""

import jax
import numpy as np

import gsvc_tpu_torch.train.fit as port_fit
from gsvc_tpu.framecube import FrameCubeDataset as JaxDataset
from gsvc_tpu.train.fit import GOPFitter as JaxFitter
from gsvc_tpu.utils.checkpoint import save_checkpoint as jax_save_ckpt
from gsvc_tpu_torch.framecube.frame import FrameCubeDataset
from gsvc_tpu_torch.models.gaussians import GenerateMode
from gsvc_tpu_torch.render.batched import can_mirror
from gsvc_tpu_torch.train.fit import GOPFitter
from gsvc_tpu_torch.utils.checkpoint import load_checkpoint
from tests.test_torch_mirror import _jax_pair_noise
from tests.test_torch_train import FOUR_PHASES, _configs
from tests.test_train import synthetic_video


def test_four_phase_fit_at_unaligned_width_matches_jax(tmp_path,
                                                       monkeypatch):
    """Twelve iterations through the four phases with three densify epochs
    on a 40 px wide GOP (16 px tiles: every step renders through B5f/B5b's
    plain versions here, JAX's through ``pallas_tile_composite``), from a
    carried-over state with JAX's noise injected, as
    tests/test_torch_train.py holds the tile-aligned fit: losses, bits per
    parameter, anchor counts and the fitters' host state."""
    jcfg, pcfg = _configs()
    for c in (jcfg, pcfg):
        for k, v in FOUR_PHASES.items():
            setattr(c.optimization, k, v)
    frames = np.round(synthetic_video(t=4, h=24, w=40) * 255).astype(
        np.uint8)
    jf = JaxFitter(jcfg, JaxDataset(images=frames.astype(np.float32)
                                    / 255.0), seed=0)
    pf = GOPFitter(pcfg, FrameCubeDataset(images=frames), seed=0,
                   device="cpu")
    assert not can_mirror(pf.settings)
    jax_save_ckpt(str(tmp_path / "jax.pkl"), jf, 0)
    load_checkpoint(str(tmp_path / "jax.pkl"), pf)

    key = [jf.key]
    make_step = port_fit.make_step_body

    def with_jax_noise(cfg, settings, window_cap, *args, **kw):
        body = make_step(cfg, settings, window_cap, *args, **kw)

        def step(*a, mode, do_stats, generator=None, noise=None,
                 timer=None):
            key[0], sk = jax.random.split(key[0])
            if mode in (GenerateMode.QUANTIZED_NOISE, GenerateMode.ENTROPY):
                noise = _jax_pair_noise(sk, cfg, window_cap)
            return body(*a, mode=mode, do_stats=do_stats, noise=noise,
                        timer=timer)
        return step

    monkeypatch.setattr(port_fit, "make_step_body", with_jax_noise)
    pf._build_step()
    jr = jf.fit(log_every=1)
    pr = pf.fit(log_every=1)
    assert [h["iter"] for h in pr.history] == list(range(1, 13))
    np.testing.assert_allclose([h["loss"] for h in pr.history],
                               [h["loss"] for h in jr.history], rtol=1e-4)
    np.testing.assert_allclose([h["bpp"] for h in pr.history],
                               [h["bpp"] for h in jr.history], rtol=5e-3)
    counts = [h["n_active"] for h in pr.history]
    assert counts == [h["n_active"] for h in jr.history]
    assert counts[2] > counts[1]                 # the first epoch grew
    assert jf.rng.bit_generator.state == pf.rng.bit_generator.state
    assert (pf.capacity, pf.window_cap) == (jf.capacity, jf.window_cap)
