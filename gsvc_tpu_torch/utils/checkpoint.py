"""Training checkpoint save/restore (port of save_checkpoint and
load_checkpoint, gsvc_tpu/utils/checkpoint.py:24-100).

One file per checkpoint, in the JAX package's format: a pickled dict of
NumPy arrays keyed by tree paths — model state, Adam moments,
densification accumulators and loop counters — so either package reads
the other's files.  ``jax_key`` holds the uint32 [2] array of
``PRNGKey(seed)`` (the JAX loader requires the key); the state of the
fitter's noise generator goes under ``torch_generator`` and its device
type under ``torch_generator_device``, which the JAX loader ignores.  A
generator state only loads into a generator of the same device type (a
CUDA state is 16 bytes, a CPU state 5,056), so on a mismatch the loader
reseeds the noise generator from (seed, iteration) and logs it.
Loading reads numpy arrays and plain Python values only.

Under a mesh (``GOPFitter(mesh=...)``) ``save_checkpoint`` gathers the
z-slabs, every rank taking part, and rank 0 writes the same file a
single-GPU fit writes; ``load_checkpoint`` into a mesh fitter re-shards
it.  So a mesh checkpoint loads into a single-GPU fitter and back.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
from typing import Dict

import numpy as np
import torch

from gsvc_tpu_torch.codec.unpickle import _NUMPY
from gsvc_tpu_torch.convert import training_state_from_numpy
from gsvc_tpu_torch.train.optim import tree_map


def _to_host(tree):
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)


def prng_key(seed: int) -> np.ndarray:
    """The raw uint32 [2] key data of ``jax.random.PRNGKey(seed)``."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def save_checkpoint(path: str, fitter, iteration: int) -> None:
    """Capture a GOPFitter's full training state (under a mesh: gathered
    on every rank, written by rank 0)."""
    state, adam, stats = fitter.state, fitter.adam, fitter.stats
    mesh = fitter.mesh
    if mesh is not None:
        from gsvc_tpu_torch.parallel.spmd import gather_training_state

        state, adam, stats = gather_training_state(state, adam, stats, mesh)
        if mesh.rank != 0:
            return
    payload = {
        "iteration": iteration,
        "capacity": fitter.capacity,
        "window_cap": fitter.window_cap,
        "voxel_size": fitter.voxel_size,
        "anchors": _to_host(state.anchors._asdict()),
        "nets": _to_host(state.nets._asdict()),
        "n_active": int(state.n_active),
        "x_bound_min": state.x_bound_min.cpu().numpy(),
        "x_bound_max": state.x_bound_max.cpu().numpy(),
        "adam_m": _to_host((adam.m[0]._asdict(), adam.m[1]._asdict())),
        "adam_v": _to_host((adam.v[0]._asdict(), adam.v[1]._asdict())),
        "adam_step": int(adam.step),
        "stats": _to_host(stats._asdict()),
        "controller_iteration": fitter.controller.current_iteration,
        "np_rng": fitter.rng.bit_generator.state,
        "jax_key": prng_key(fitter.seed),
        "torch_generator": fitter.generator.get_state().numpy(),
        "torch_generator_device": fitter.generator.device.type,
        "gaussian_cap": fitter.settings.gaussian_cap,
        "tiles_per_gaussian": fitter.settings.tiles_per_gaussian,
        "copy_budget_factor": fitter.settings.copy_budget_factor,
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f)


class _CheckpointUnpickler(pickle.Unpickler):
    """Admits numpy's array reconstruction and nothing else."""

    def find_class(self, module, name):
        found = _NUMPY.get((module, name))
        if found is None:
            raise pickle.UnpicklingError(
                f"global {module}.{name} is not allowed in a checkpoint")
        return found


def read_checkpoint(path: str) -> dict:
    with open(path, "rb") as f:
        return _CheckpointUnpickler(io.BytesIO(f.read())).load()


def _seed_of(p: dict, default: int) -> int:
    """The run's seed from the stored ``PRNGKey(seed)`` words."""
    key = p.get("jax_key")
    if key is None:
        return int(default)
    hi, lo = (int(v) for v in np.asarray(key, np.uint32).reshape(-1)[:2])
    return (hi << 32) | lo


def _restore_generator(fitter, p: dict) -> None:
    """Restore the noise generator's state when it was saved on the same
    device type (inferred from the state's size for checkpoints that
    predate ``torch_generator_device``), else reseed it from (seed,
    iteration)."""
    state = torch.from_numpy(np.asarray(p["torch_generator"], np.uint8))
    gen = fitter.generator
    saved = p.get("torch_generator_device")
    same = (saved == gen.device.type if saved is not None
            else state.numel() == gen.get_state().numel())
    if same:
        gen.set_state(state)
        return
    seed, it = _seed_of(p, fitter.seed), int(p["iteration"])
    new_seed = int(np.random.SeedSequence([seed, it]).generate_state(
        1, np.uint64)[0])
    gen.manual_seed(new_seed)
    fitter.log(f"checkpoint: the noise generator's state was saved on "
               f"{saved or f'another device ({state.numel()} bytes)'} and "
               f"does not load on {gen.device.type}; reseeded from (seed "
               f"{seed}, iteration {it})")


def load_checkpoint(path: str, fitter) -> int:
    """Restore into an already-constructed GOPFitter (same config and
    dataset), from a file of either package; a mesh fitter takes its
    shards (every rank reads the file).  Returns the iteration to resume
    from."""
    p = read_checkpoint(path)
    mesh = fitter.mesh
    if mesh is not None and p["capacity"] % mesh.size("sp"):
        raise ValueError(f"capacity {p['capacity']} does not split into "
                         f"{mesh.size('sp')} z-slabs")
    fitter.capacity = p["capacity"]
    fitter.window_cap = p["window_cap"]
    fitter.voxel_size = p["voxel_size"]
    fitter.state, fitter.adam, fitter.stats = training_state_from_numpy(
        p, device=fitter.device)
    if mesh is not None:
        from gsvc_tpu_torch.parallel.spmd import (
            shard_adam_state, shard_model_state, shard_train_stats,
        )

        fitter.state = shard_model_state(fitter.state, mesh)
        fitter.adam = shard_adam_state(fitter.adam, mesh)
        fitter.stats = shard_train_stats(fitter.stats, mesh)
        # each rank windows its own slab (a single-GPU file's window may
        # be wider than one)
        fitter.window_cap = min(fitter.window_cap,
                                fitter.capacity // mesh.size("sp"))
    fitter.controller.current_iteration = p["controller_iteration"]
    fitter.rng.bit_generator.state = p["np_rng"]
    if "torch_generator" in p:
        _restore_generator(fitter, p)
    if mesh is not None and mesh.dp_index > 0:
        # the file holds dp group 0's noise generator; the others draw
        # their own stream, seeded from (seed, iteration, dp index)
        seed, it = _seed_of(p, fitter.seed), int(p["iteration"])
        fitter.generator.manual_seed(int(np.random.SeedSequence(
            [seed, it, mesh.dp_index]).generate_state(1, np.uint64)[0]))
    if "gaussian_cap" in p:
        fitter.settings = dataclasses.replace(
            fitter.settings, gaussian_cap=p["gaussian_cap"],
            tiles_per_gaussian=p["tiles_per_gaussian"],
            copy_budget_factor=p.get("copy_budget_factor",
                                     fitter.settings.copy_budget_factor))
    fitter._build_step()
    return p["iteration"]


def save_streams(path_dir: str, streams: Dict[str, bytes]) -> int:
    """Write each stream to its own file of ``path_dir``; returns the
    total bytes (gsvc_tpu/utils/checkpoint.py:103)."""
    os.makedirs(path_dir, exist_ok=True)
    total = 0
    for name, data in streams.items():
        with open(os.path.join(path_dir, name), "wb") as f:
            f.write(data)
        total += len(data)
    return total
