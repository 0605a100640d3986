"""Multi-rank training on ``torch.distributed`` (port of
gsvc_tpu/parallel/spmd.py): frame-pair data parallelism (``dp``) times
z-slab model parallelism (``sp``), and the GOP fan-out.

The JAX package runs this path as one process over a device mesh
(``shard_map``); the port runs one process a rank over an initialised
process group.  ``make_mesh(n_dp, n_sp)`` lays the ranks out as JAX's
``reshape(n_dp, n_sp)``: ``rank = dp_index * n_sp + sp_index``, and shard
``s`` of the anchors holds z-slab ``s``.

* ``dp``: each dp group fits a different frame pair a step; anchor
  gradients are averaged over dp, net gradients summed over sp and
  averaged over dp, the densification statistics summed over dp.
* ``sp``: the anchor buffers are z-sorted, so an equal row split is a
  contiguous z-slab a rank.  Each rank composites its own gaussians into
  a partial (premultiplied colour, transmittance) image with ``bg = 0``;
  ``combine_slab_renders`` composites the partials in slab order through
  a log-transmittance exchange (an all-gather, or ``neighbors`` rounds of
  ``ppermute``) and one ``psum`` of the colours.

The four collectives (``psum``, ``pmean``, ``all_gather``, ``ppermute``)
are autograd functions whose backward is JAX's transpose under
``shard_map(check_vma=False)``: the transpose of ``psum`` is ``psum``, of
``all_gather`` the sum over ranks of each rank's slice, of ``ppermute``
the inverse permutation.  Since every rank of an sp group computes the
same loss, every gradient that passes through a collective arrives
multiplied by ``n_sp``, before the explicit ``psum`` over sp of the net
gradients, exactly as in the JAX package (a fact of the reference, held
by tests/test_torch_spmd.py through the Adam moments).

Transport: NCCL moves CUDA tensors; gloo moves CPU tensors and, for
``all_reduce`` and ``all_gather``, CUDA tensors.  gloo has no CUDA path
for ``send``/``recv``, so ``ppermute`` over gloo stages a CUDA tensor
through the host: an explicit copy each way, counted in
``Mesh.stats.host_copies``.  ``Mesh.stats`` counts each rank's
collective calls and payload bytes; nothing here synchronises the device
(a caller that wants their time wraps ``_reduce``, ``_gather`` and
``_permute`` itself, as chip_smoke.py does).  Every process group has a
timeout (``GROUP_TIMEOUT``), so a rank that dies fails the others
instead of hanging them.

The GOP fan-out (``GopRankFitter``, ``fit_gops``): each dp rank fits one
GOP with a single-GPU ``GOPFitter`` (no collective in the step); the
random draws JAX takes from one ``numpy.random.Generator`` across all
GOPs (initial point clouds, every step's frame indices, the densify
epochs) are replayed on every rank, which keeps its own GOP's.
"""

from __future__ import annotations

import datetime
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gsvc_tpu_torch.config import ModelConfig, OptimizationConfig
from gsvc_tpu_torch.metrics.image import psnr
from gsvc_tpu_torch.models.gaussians import (
    AnchorState, GaussianConfig, GenerateMode, ModelState,
)
from gsvc_tpu_torch.ops.entropy import binary_vxl_size
from gsvc_tpu_torch.ops.quant import ste_binary
from gsvc_tpu_torch.render.batched import render_pair
from gsvc_tpu_torch.render.splat import RasterSettings
from gsvc_tpu_torch.train.fit import GOPFitter, compute_window_cap
from gsvc_tpu_torch.train.optim import (
    AdamState, adam_update, build_lr_tree, tree_leaves, tree_map,
    tree_unflatten,
)
from gsvc_tpu_torch.train.trainer import (
    StepMetrics, TrainStats, accumulate_stats, gt_f32, init_stats,
    optical_flow_terms,
)

GROUP_TIMEOUT = datetime.timedelta(seconds=300)


# ---------------------------------------------------------------------------
# Ranks, backends and the mesh
# ---------------------------------------------------------------------------

def parse_mesh_spec(spec: str) -> dict:
    """'dp=2,sp=4' -> {'dp': 2, 'sp': 4} (the config.py ``mesh_shape``
    knob and the CLI ``--mesh`` flag)."""
    out = {"dp": 1, "sp": 1}
    for part in spec.replace(" ", "").split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        if k not in out:
            raise ValueError(f"unknown mesh axis {k!r} (want dp/sp)")
        out[k] = int(v)
    return out


def choose_backend(device_type: str, world: int) -> str:
    """The backend rule: ``cpu`` -> gloo; CUDA with at least ``world``
    cards -> NCCL (rank r on ``cuda:r``); CUDA with fewer -> gloo (rank r
    on ``cuda:(r % count)``, ranks sharing a card).  Never chosen by
    failure: a backend that then fails raises."""
    if device_type == "cpu":
        return "gloo"
    if device_type != "cuda":
        raise ValueError(f"no process-group backend for {device_type!r}")
    return "nccl" if torch.cuda.device_count() >= world else "gloo"


def rank_device(device: str, rank: int) -> torch.device:
    """Rank ``rank``'s device for the ``--device`` value ``device``:
    ``cuda`` -> ``cuda:(rank % card count)``; anything else as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run the plain PyTorch path")
    return torch.device("cuda", rank % torch.cuda.device_count())


class CollectiveStats:
    """What the collectives of one rank move: calls, payload bytes, and
    the explicit host copies of gloo's staged ``send``/``recv``."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0
        self.host_copies = 0
        self.host_bytes = 0

    def add(self, nbytes: int):
        self.calls += 1
        self.bytes += nbytes

    def as_dict(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes,
                "host_copies": self.host_copies,
                "host_bytes": self.host_bytes}


class Mesh:
    """The (dp, sp) mesh of this rank: ``shape`` ({"dp", "sp"}), this
    rank's ``index(axis)``, one process group per axis (``groups``) with
    the global ranks of its members in index order (``ranks``), the
    backend, this rank's device and its ``CollectiveStats``."""

    def __init__(self, n_dp: int, n_sp: int, rank: int, groups: dict,
                 ranks: dict, backend: str, device: torch.device):
        self.shape = {"dp": n_dp, "sp": n_sp}
        self.rank = rank
        self.dp_index, self.sp_index = divmod(rank, n_sp)
        self.groups = groups
        self.ranks = ranks
        self.backend = backend
        self.device = device
        self.stats = CollectiveStats()

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.dp_index if axis == "dp" else self.sp_index


def make_mesh(n_dp: int = 1, n_sp: int = 1, device=None) -> Mesh:
    """The mesh over the initialised default process group, whose world
    size must be ``n_dp * n_sp``.  Every rank must call it (each axis'
    groups are made with ``new_group`` on every rank, in one order)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group")
    world = dist.get_world_size()
    if world != n_dp * n_sp:
        raise ValueError(f"need {n_dp * n_sp} ranks, have {world}")
    rank = dist.get_rank()
    dp_i, sp_i = divmod(rank, n_sp)
    groups, ranks = {}, {}
    for axis, n_groups, members in (
            ("sp", n_dp, lambda g: [g * n_sp + s for s in range(n_sp)]),
            ("dp", n_sp, lambda g: [d * n_sp + g for d in range(n_dp)])):
        mine = dp_i if axis == "sp" else sp_i
        for g in range(n_groups):
            r = members(g)
            grp = dist.new_group(r, timeout=GROUP_TIMEOUT)
            if g == mine:
                groups[axis], ranks[axis] = grp, r
    dev = torch.device(device) if device is not None else torch.device(
        "cpu")
    return Mesh(n_dp, n_sp, rank, groups, ranks, dist.get_backend(), dev)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum over ``axis`` into a new tensor."""
    out = x.detach().contiguous().clone()
    if mesh.size(axis) > 1:
        mesh.stats.add(_nbytes(out))
        dist.all_reduce(out, group=mesh.groups[axis])
    return out


def _gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """[D, *x.shape]: every rank's ``x`` in index order."""
    x = x.detach().contiguous()
    if mesh.size(axis) == 1:
        return x[None].clone()
    parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
    mesh.stats.add(_nbytes(x) * len(parts))
    dist.all_gather(parts, x, group=mesh.groups[axis])
    return torch.stack(parts)


def _permute(x: torch.Tensor, mesh: Mesh, axis: str, perm) -> torch.Tensor:
    """JAX's ``ppermute``: ``perm`` holds (source, destination) indices
    along ``axis``; a rank that is no destination receives zeros.  Over
    gloo a CUDA tensor goes through the host (gloo's ``send``/``recv``
    take CPU tensors only): one counted copy each way."""
    me = mesh.index(axis)
    x = x.detach().contiguous()
    out = torch.zeros_like(x)
    dsts = [d for s, d in perm if s == me]
    srcs = [s for s, d in perm if d == me]
    if not dsts and not srcs:
        return out
    staged = mesh.backend == "gloo" and x.is_cuda
    st = mesh.stats
    st.add(_nbytes(x) * (len(dsts) + len(srcs)))
    buf = x
    if staged and dsts:
        buf = x.cpu()
        st.host_copies += 1
        st.host_bytes += _nbytes(x)
    elif staged:
        buf = torch.empty(x.shape, dtype=x.dtype)
    ranks, grp = mesh.ranks[axis], mesh.groups[axis]
    ops = [dist.P2POp(dist.isend, buf, ranks[d], group=grp) for d in dsts]
    recv = [torch.empty_like(buf) for _ in srcs]
    ops += [dist.P2POp(dist.irecv, r, ranks[s], group=grp)
            for r, s in zip(recv, srcs)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for r in recv:
        if staged:
            r = r.to(x.device)
            st.host_copies += 1
            st.host_bytes += _nbytes(x)
        out += r
    return out


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        # JAX's transpose of psum is psum
        return _reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        # JAX's transpose (psum_scatter): the sum over ranks of each
        # rank's cotangent of this rank's slice
        me = ctx.mesh.index(ctx.axis)
        return _reduce(g, ctx.mesh, ctx.axis)[me], None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.inverse = [(d, s) for s, d in perm]
        return _permute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return (_permute(g, ctx.mesh, ctx.axis, ctx.inverse), None, None,
                None)


def psum(x: torch.Tensor, mesh: Mesh, axis: str = "sp") -> torch.Tensor:
    """Sum over ``axis`` (``jax.lax.psum``)."""
    return _PSum.apply(x, mesh, axis)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str = "sp") -> torch.Tensor:
    """``psum(x) / size`` (``jax.lax.pmean``)."""
    return psum(x, mesh, axis) / mesh.size(axis)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = "sp"
               ) -> torch.Tensor:
    """[D, *x.shape] in index order (``jax.lax.all_gather``)."""
    return _AllGather.apply(x, mesh, axis)


def ppermute(x: torch.Tensor, mesh: Mesh, perm, axis: str = "sp"
             ) -> torch.Tensor:
    """``jax.lax.ppermute``: (source, destination) index pairs; a rank
    with no source receives zeros."""
    return _PPermute.apply(x, mesh, axis, list(perm))


def _gather_flat(tensors: list, mesh: Mesh, axis: str) -> list:
    """Every rank's ``tensors`` in one all-gather of one flat float32
    buffer: for each input, [D, *shape]."""
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for t in tensors])
    got = _gather(flat, mesh, axis)
    out, o = [], 0
    for t in tensors:
        n = t.numel()
        out.append(got[:, o:o + n].reshape((-1,) + tuple(t.shape))
                   .to(t.dtype))
        o += n
    return out


def _reduce_flat(tensors: list, mesh: Mesh, axis: str) -> list:
    """Elementwise sums over ``axis`` of ``tensors`` (float32) in one
    all-reduce."""
    if mesh.size(axis) == 1:
        return [t.detach() for t in tensors]
    flat = _reduce(torch.cat([t.detach().reshape(-1) for t in tensors]),
                   mesh, axis)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o:o + t.numel()].reshape(t.shape))
        o += t.numel()
    return out


# ---------------------------------------------------------------------------
# Sharding
# ---------------------------------------------------------------------------

def _slab(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    rows = x.shape[0] // mesh.size("sp")
    s = mesh.sp_index
    return x[s * rows:(s + 1) * rows].clone()


def shard_model_state(state: ModelState, mesh: Mesh) -> ModelState:
    """This rank's z-slab of every anchor buffer (rows ``[s C / n_sp,
    (s + 1) C / n_sp)``); the nets, ``n_active`` and the bounds stay
    replicated.  The buffers are z-sorted with z = 1e9 padding, so the
    slabs are contiguous in z."""
    return state._replace(anchors=AnchorState(
        *(_slab(x, mesh) for x in state.anchors)))


def shard_adam_state(adam: AdamState, mesh: Mesh) -> AdamState:
    """Anchor moments follow the anchor sharding; net moments replicate."""
    return AdamState(
        m=(AnchorState(*(_slab(x, mesh) for x in adam.m[0])), adam.m[1]),
        v=(AnchorState(*(_slab(x, mesh) for x in adam.v[0])), adam.v[1]),
        step=adam.step)


def shard_train_stats(stats: TrainStats, mesh: Mesh) -> TrainStats:
    return TrainStats(*(_slab(x, mesh) for x in stats))


def gather_slabs(tensors: list, mesh: Mesh) -> list:
    """The global buffers from each rank's slabs, in shard order (= the
    global z order): one all-gather over sp."""
    return [g.reshape((-1,) + tuple(g.shape[2:]))
            for g in _gather_flat(tensors, mesh, "sp")]


def gather_training_state(state: ModelState, adam: AdamState,
                          stats: TrainStats, mesh: Mesh):
    """(ModelState, AdamState, TrainStats) with the global anchor buffers
    on every rank (one all-gather over sp)."""
    local = (list(state.anchors) + list(adam.m[0]) + list(adam.v[0])
             + list(stats))
    got = gather_slabs(local, mesh)
    na = len(AnchorState._fields)
    anchors = AnchorState(*got[:na])
    m = AnchorState(*got[na:2 * na])
    v = AnchorState(*got[2 * na:3 * na])
    return (state._replace(anchors=anchors),
            AdamState(m=(m, adam.m[1]), v=(v, adam.v[1]), step=adam.step),
            TrainStats(*got[3 * na:]))


# ---------------------------------------------------------------------------
# The slab composite and the SPMD train step
# ---------------------------------------------------------------------------

def combine_slab_renders(partial_img, partial_t, flip: bool, bg: float,
                         mesh: Mesh, axis: str = "sp",
                         neighbors: Optional[int] = None):
    """Composite per-slab partial renders across the ``sp`` axis.

    partial_img: local [..., 3, H, W] premultiplied colour (rendered with
    bg = 0); partial_t: local [..., H, W] transmittance (leading axes are
    views composited alike).  Slabs are z-ascending by shard index; the
    forward view looks toward -z, so HIGHER shard indices are nearer (the
    flipped view: lower).  Each rank weights its colours by the
    transmittance product of the nearer slabs, and the frame is one psum.

    ``neighbors``: with the fitter's ``window_cap <= slab_rows`` clamp a
    frame's TSW window spans at most ``neighbors + 1`` consecutive slabs,
    so every slab outside it has log T = 0 and a rank needs the log-T
    maps of its ``neighbors`` nearer neighbours only: that many ppermute
    rounds instead of the all-gather.  ``None`` all-gathers (right for
    any window).  Returns (image, total transmittance)."""
    log_t = torch.log(torch.clamp(partial_t, min=1e-30))
    d = mesh.size(axis)
    if neighbors is not None and neighbors < d - 1:
        step = 1 if not flip else -1
        excl = torch.zeros_like(log_t)
        for o in range(1, neighbors + 1):
            # receive log T from the o-th nearer neighbour; a rank with
            # none receives zeros
            perm = [(s, s - step * o) for s in range(d)
                    if 0 <= s - step * o < d]
            excl = excl + ppermute(log_t, mesh, perm, axis)
        out = psum(partial_img * torch.exp(excl).unsqueeze(-3), mesh, axis)
        t_all = torch.exp(psum(log_t, mesh, axis))
        return out + t_all.unsqueeze(-3) * bg, t_all
    ts = all_gather(log_t, mesh, axis)                       # [D, ...]
    idx = mesh.index(axis)
    slabs = torch.arange(d, device=log_t.device)
    nearer = (slabs > idx) if not flip else (slabs < idx)
    nearer = nearer.reshape((d,) + (1,) * log_t.dim())
    excl = torch.sum(torch.where(nearer, ts, torch.zeros_like(ts)), dim=0)
    out = psum(partial_img * torch.exp(excl).unsqueeze(-3), mesh, axis)
    t_all = torch.exp(torch.sum(ts, dim=0))
    return out + t_all.unsqueeze(-3) * bg, t_all


def _psum_ratios(pairs, mesh: Mesh, axis: str = "sp") -> list:
    """``psum(num) / max(psum(den), 1)`` for each (num, den) pair, the
    sums in one psum (elementwise the same as one psum each)."""
    s = psum(torch.stack([t for p in pairs for t in p]), mesh, axis)
    return [s[2 * i] / torch.clamp(s[2 * i + 1], min=1.0)
            for i in range(len(pairs))]


def make_spmd_train_step(cfg: GaussianConfig, settings: RasterSettings,
                         window_cap: int, opt: OptimizationConfig,
                         width: int, height: int, scale: float,
                         x_min: float, y_min: float, mesh: Mesh,
                         rasterizer: str = "",
                         overlap_neighbors: Optional[int] = None):
    """The SPMD train step on this rank: its dp group's frame pair, its
    z-slab.  Returns

        step(state, adam, stats, lr_values, z1, z2, gt1, gt2, flow, mode,
             do_stats=False, generator=None, noise=None, timer=None)
            -> (state, adam, stats, StepMetrics)

    with ``state``/``adam``/``stats`` this rank's shards and z1 .. flow
    its dp group's pair (JAX takes the [n_dp]-batched arrays, sharded over
    dp).  ``generator`` draws the noise of the noise-quantised phases (one
    per dp group: the sp ranks of a group draw alike, as JAX's ``keys[B]``
    on each shard); ``noise`` injects the draws instead (tests).
    ``overlap_neighbors``: see ``combine_slab_renders``."""
    k = cfg.n_offsets
    # partial renders use bg = 0; the background is added after the
    # combine
    local_settings = RasterSettings(**{**settings.__dict__, "bg": 0.0})
    bg = settings.bg
    use_optical = opt.optical_lambda != 0.0
    entropy = (GenerateMode.ENTROPY, GenerateMode.STE_ENTROPY)

    def _pair_loss(st, z1, z2, gt1, gt2, flow, mode, m2d, generator,
                   noise, timer):
        pr = render_pair(st, cfg, z1, z2, x_min, y_min, scale,
                         local_settings, window_cap, mode,
                         generator=generator, means2d=m2d, noise=noise,
                         timer=timer, rasterizer=rasterizer)
        renders = pr.renders
        # the forward views (0, 2) and the flipped views (1, 3) each in
        # one combine
        fwd = combine_slab_renders(pr.images[0::2], pr.transmittances[0::2],
                                   False, bg, mesh,
                                   neighbors=overlap_neighbors)[0]
        flp = combine_slab_renders(pr.images[1::2], pr.transmittances[1::2],
                                   True, bg, mesh,
                                   neighbors=overlap_neighbors)[0]
        image1 = (fwd[0] + torch.flip(flp[0], [-1])) / 2.0
        image2 = (fwd[1] + torch.flip(flp[1], [-1])) / 2.0

        l1 = (torch.mean(torch.abs(image1 - gt1))
              + torch.mean(torch.abs(image2 - gt2)))
        from gsvc_tpu_torch.metrics.image import ssim

        dssim = (1.0 - ssim(image1, gt1)) + (1.0 - ssim(image2, gt2))

        # every term's local (sum, count), psum'd for the exact global
        # ratio: the regularisers, the optical term (gaussian matching is
        # slab-local: both windows slice the same slab) and the
        # count-weighted rate
        pairs = []
        for r in renders:
            sel = r.selection_mask.to(torch.float32)
            pairs.append((torch.sum(torch.prod(r.scaling, dim=1) * sel),
                          torch.sum(sel)))
        for r in renders:
            inw = torch.repeat_interleave(r.in_window, k).to(torch.float32)
            pairs.append((torch.sum((1.0 - r.neural_opacity[:, 0]) * inw),
                          torch.sum(inw)))
        for r in renders:
            pairs.append((r.rate.bits_total, r.rate.params_total))
        if use_optical:
            r1f, r1b, r2f, r2b = renders
            for ra, rb in ((r1f, r2f), (r1b, r2b)):
                pairs.append(optical_flow_terms(ra, rb, flow, x_min, y_min,
                                                scale, width, height, k))
        ratios = _psum_ratios(pairs, mesh)
        scaling_reg = sum(ratios[0:4])
        opacity_reg = sum(ratios[4:8])
        bpp = sum(ratios[8:12])
        optical = (ratios[12] + ratios[13] if use_optical
                   else torch.zeros((), device=image1.device))

        loss = ((1.0 - opt.lambda_dssim) * l1 + opt.lambda_dssim * dssim
                + opt.scaling_reg * scaling_reg
                + opt.opacity_reg * opacity_reg
                + opt.optical_lambda * optical)
        if mode in entropy:
            hash_bin = (ste_binary(st.nets.hash_table) + 1) / 2
            _, bit_hash, _, _ = binary_vxl_size(hash_bin)
            rows = torch.tensor(float(st.anchors.anchor.shape[0]),
                                device=image1.device)
            denom = psum(rows, mesh) * (cfg.feat_dim + 6 + 3 * k)
            loss = loss + opt.lmbda * (bpp + bit_hash / denom)
            loss = loss + opt.mask_reg * pmean(
                torch.mean(torch.sigmoid(st.anchors.mask)), mesh)

        with torch.no_grad():
            ps = (psnr(image1, gt1) + psnr(image2, gt2)) / 2.0
            # the sp sums of the telemetry in one psum (float64: the
            # counts stay exact); bit_per_*_param are psum'd / n_sp, as
            # JAX's _psum_ratio(x, 1)
            tele = torch.stack([torch.as_tensor(t).to(torch.float64)
                                for t in (
                sum(r.rate.bit_per_feat_param for r in renders),
                sum(r.rate.bit_per_scaling_param for r in renders),
                sum(r.rate.bit_per_offsets_param for r in renders),
                sum(r.num_rendered for r in renders),
                sum(r.overflow for r in renders),
                sum(r.harmful_overflow for r in renders),
                sum(torch.sum(r.visibility_filter) for r in renders),
                sum(torch.mean(r.selection_mask.float())
                    for r in renders) / 4.0)])
            tele = _reduce(tele, mesh, "sp")
            n_sp = float(mesh.size("sp"))
            metrics = StepMetrics(
                loss=loss.detach(), l1=l1.detach(), psnr=ps,
                scaling_reg=scaling_reg.detach(),
                optical_loss=optical.detach(),
                bit_per_param=bpp.detach() / 4.0,
                bit_per_feat_param=(tele[0] / n_sp).float() / 4.0,
                bit_per_scaling_param=(tele[1] / n_sp).float() / 4.0,
                bit_per_offsets_param=(tele[2] / n_sp).float() / 4.0,
                num_rendered=tele[3], overflow=tele[4],
                active_gaussians=tele[6],
                mask_ratio=(tele[7] / n_sp).float(),
                harmful_overflow=tele[5])
        return loss, renders, metrics

    def spmd_step(state: ModelState, adam: AdamState, stats: TrainStats,
                  lr_values: dict, z1, z2, gt1, gt2, flow,
                  mode: GenerateMode, do_stats: bool = False,
                  generator=None, noise=None, timer=None):
        if timer is not None:
            timer.mark("start")
        gt1, gt2, flow = gt_f32(gt1), gt_f32(gt2), gt_f32(flow)
        params = (state.anchors, state.nets)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        p_tree = tree_unflatten(params, leaves)
        st = state._replace(anchors=p_tree[0], nets=p_tree[1])
        dev = state.anchors.anchor.device
        m2d = None
        if do_stats:
            m2d = torch.zeros((4, window_cap * k, 2), dtype=torch.float32,
                              device=dev, requires_grad=True)
        loss, renders, metrics = _pair_loss(st, z1, z2, gt1, gt2, flow,
                                            mode, m2d, generator, noise,
                                            timer)
        if timer is not None:
            timer.mark("loss_end")
        inputs = leaves + ([m2d] if do_stats else [])
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, inputs)]
        if timer is not None:
            timer.mark("backward_end")
        if do_stats:
            local = accumulate_stats(
                init_stats(state.anchors.anchor.shape[0], k, dev), renders,
                grads[-1], scale, k)
            # per-anchor statistics live on their slab; sum samples over dp
            stats = TrainStats(*(a + d for a, d in zip(
                stats, _reduce_flat(list(local), mesh, "dp"))))
            grads = grads[:-1]
        n_dp = mesh.size("dp")
        n_anchor = len(AnchorState._fields)
        # anchor grads live on their slab -> mean over dp; net grads are
        # partial contributions -> sum over sp, mean over dp
        g_anchor = [g / n_dp for g in _reduce_flat(grads[:n_anchor], mesh,
                                                   "dp")]
        g_nets = [g / n_dp for g in _reduce_flat(
            _reduce_flat(grads[n_anchor:], mesh, "sp"), mesh, "dp")]
        with torch.no_grad():
            new_params, adam = adam_update(
                params, tree_unflatten(params, g_anchor + g_nets), adam,
                build_lr_tree(params, lr_values))
            red = _reduce_flat([v.to(torch.float64).reshape(1)
                                for v in metrics], mesh, "dp")
            metrics = StepMetrics(*(
                (r.reshape(()) / n_dp).to(v.dtype if v.is_floating_point()
                                          else torch.float64)
                for r, v in zip(red, metrics)))
        if timer is not None:
            timer.mark("adam_end")
        new_state = state._replace(anchors=new_params[0],
                                   nets=new_params[1])
        return new_state, adam, stats, metrics

    return spmd_step


# ---------------------------------------------------------------------------
# Densification under SPMD: host re-shard epochs
# ---------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _host_prefix(tree, n: int) -> dict:
    return {f: getattr(tree, f)[:n].detach().cpu().numpy().copy()
            for f in AnchorState._fields}


def _stats_host(stats: TrainStats, n: int, k: int) -> dict:
    return {
        "opacity_accum": stats.opacity_accum[:n].cpu().numpy().copy(),
        "anchor_demon": stats.anchor_demon[:n].cpu().numpy().copy(),
        "offset_gradient_accum":
            stats.offset_gradient_accum[:n * k].cpu().numpy().copy(),
        "offset_denom": stats.offset_denom[:n * k].cpu().numpy().copy()}


def _pad_training(anchors: dict, adam_m: dict, adam_v: dict, stats_h: dict,
                  n_new: int, cap: int, k: int, device):
    """Host arrays padded to ``cap`` rows (anchor z = 1e9 past the live
    prefix) as (AnchorState, m AnchorState, v AnchorState, TrainStats)
    on ``device``."""
    def pad_to(x, rows):
        out = np.zeros((rows,) + x.shape[1:], np.float32)
        out[:x.shape[0]] = x
        return torch.from_numpy(out).to(device)

    anchor_pad = np.zeros((cap, 3), np.float32)
    anchor_pad[:n_new] = anchors["anchor"]
    anchor_pad[n_new:, 2] = 1e9
    new_anchors = AnchorState(
        anchor=torch.from_numpy(anchor_pad).to(device),
        **{f: pad_to(anchors[f], cap) for f in AnchorState._fields
           if f != "anchor"})
    new_m = AnchorState(**{f: pad_to(adam_m[f], cap)
                           for f in AnchorState._fields})
    new_v = AnchorState(**{f: pad_to(adam_v[f], cap)
                           for f in AnchorState._fields})
    new_stats = TrainStats(
        opacity_accum=pad_to(stats_h["opacity_accum"], cap),
        anchor_demon=pad_to(stats_h["anchor_demon"], cap),
        offset_gradient_accum=pad_to(stats_h["offset_gradient_accum"],
                                     cap * k),
        offset_denom=pad_to(stats_h["offset_denom"], cap * k))
    return new_anchors, new_m, new_v, new_stats


def spmd_densify_epoch(state: ModelState, adam: AdamState,
                       stats: TrainStats, mesh: Mesh,
                       model_cfg: ModelConfig, opt: OptimizationConfig,
                       voxel_size: float, rng: np.random.Generator,
                       n_offsets: int, capacity: Optional[int] = None):
    """Grow/prune/z-resort on the host, then re-pad and re-shard.

    The slabs are gathered in shard order (the global z order), so every
    rank holds the live prefix and runs the single-GPU host routines on
    the same arrays with its own copy of the same ``rng``: the results
    and the generator's state stay equal on every rank without a
    broadcast (``adjust_anchors`` draws depend only on those arrays).
    The capacity is rounded to a mesh-divisible quantum.  Returns
    (state, adam, stats, result, capacity), this rank's shards."""
    from gsvc_tpu_torch.train.densify import adjust_anchors, resort_by_z

    g_state, g_adam, g_stats = gather_training_state(state, adam, stats,
                                                     mesh)
    n = int(state.n_active)
    k = n_offsets
    anchors = _host_prefix(g_state.anchors, n)
    adam_m = _host_prefix(g_adam.m[0], n)
    adam_v = _host_prefix(g_adam.v[0], n)
    stats_h = _stats_host(g_stats, n, k)

    res = adjust_anchors(anchors, adam_m, adam_v, stats_h, model_cfg, opt,
                         voxel_size, rng)
    resort_by_z(anchors, adam_m, adam_v, stats_h, k)

    n_new = res.n_active
    n_sp = mesh.size("sp")
    quantum = max(1024, n_sp)
    cap = capacity if capacity and capacity >= n_new else \
        _round_up(int(n_new * 1.5), quantum)
    cap = _round_up(cap, n_sp)
    new_anchors, new_m, new_v, new_stats = _pad_training(
        anchors, adam_m, adam_v, stats_h, n_new, cap, k,
        state.anchors.anchor.device)
    state = state._replace(anchors=new_anchors, n_active=n_new)
    adam = AdamState(m=(new_m, adam.m[1]), v=(new_v, adam.v[1]),
                     step=adam.step)
    return (shard_model_state(state, mesh), shard_adam_state(adam, mesh),
            shard_train_stats(new_stats, mesh), res, cap)


# ---------------------------------------------------------------------------
# GOP fan-out: independent fits, one GOP a dp rank
# ---------------------------------------------------------------------------

def stack_states(state: ModelState, mesh: Mesh) -> ModelState:
    """Every dp rank's GOP state on every rank: the tensors gain a leading
    [G] axis, ``n_active`` becomes a list.  (The JAX package stacks the
    per-GOP pytrees to shard them over dp; here each dp rank holds its own
    GOP, and this gathers them, one all-gather over dp.)  The GOPs share
    one capacity, so the shapes agree."""
    leaves = tree_leaves((state.anchors, state.nets, state.x_bound_min,
                          state.x_bound_max))
    got = _gather_flat(leaves, mesh, "dp")
    anchors, nets, lo, hi = tree_unflatten(
        (state.anchors, state.nets, state.x_bound_min, state.x_bound_max),
        got)
    n = _gather(torch.tensor([state.n_active]), mesh, "dp")
    return ModelState(anchors=anchors, nets=nets,
                      n_active=[int(v) for v in n.reshape(-1)],
                      x_bound_min=lo, x_bound_max=hi)


def unstack_states(tree, n: int) -> list:
    """The per-GOP trees of a ``stack_states`` result."""
    return [tree_map(lambda x: x[i], tree) for i in range(n)]


def make_gop_parallel_step(cfg: GaussianConfig, settings: RasterSettings,
                           window_cap: int, opt: OptimizationConfig,
                           width: int, height: int, scale: float,
                           x_min: float, y_min: float, mesh: Mesh,
                           rasterizer: str = ""):
    """This dp rank's step of the GOP fan-out: the single-GPU step body on
    its own GOP, with no collective (each GOP is an independent model),
    every GenerateMode and the densification statistics included.

    Returns step(state, adam, stats, lr_values, z1, z2, gt1, gt2, flow,
    mode, do_stats=False, generator=None, noise=None) -> (state, adam,
    stats, {"loss", "psnr", "bpp", "overflow", "num_rendered"})."""
    from gsvc_tpu_torch.train.trainer import make_step_body

    body = make_step_body(cfg, settings, window_cap, opt, width, height,
                          scale, x_min, y_min, rasterizer=rasterizer)

    def step(state, adam, stats, lr_values, z1, z2, gt1, gt2, flow,
             mode: GenerateMode, do_stats: bool = False, generator=None,
             noise=None):
        state, adam, stats, m = body(state, adam, stats, lr_values, z1, z2,
                                     gt1, gt2, flow, mode, do_stats,
                                     generator=generator, noise=noise)
        return state, adam, stats, {
            "loss": m.loss, "psnr": m.psnr, "bpp": m.bit_per_param,
            "overflow": m.overflow, "num_rendered": m.num_rendered}

    return step


def gop_densify_epoch(state: ModelState, adam: AdamState,
                      stats: TrainStats, mesh: Mesh, model_cfg: ModelConfig,
                      opt: OptimizationConfig, voxel_size: float,
                      rng: np.random.Generator, n_offsets: int,
                      capacity: int):
    """Synchronised densify epoch of the fan-out.  Every GOP's live arrays
    are gathered over dp (one all-gather of the padded buffers and the
    counts: an epoch is rare), and every rank runs JAX's loop over all
    GOPs with the shared ``rng`` (so its draws stay JAX's), keeping its
    own GOP.  The capacity is shared: the max over GOPs, padded.  Returns
    (state, adam, stats, results for every GOP, capacity)."""
    from gsvc_tpu_torch.train.densify import adjust_anchors, resort_by_z

    k = n_offsets
    local = (list(state.anchors) + list(adam.m[0]) + list(adam.v[0])
             + list(stats))
    got = _gather_flat(local, mesh, "dp")
    counts = _gather(torch.tensor([int(state.n_active)]), mesh, "dp")
    na = len(AnchorState._fields)
    per, results = [], []
    for gi in range(mesh.size("dp")):
        n = int(counts[gi, 0])
        anchors = _host_prefix(AnchorState(*(g[gi] for g in got[:na])), n)
        adam_m = _host_prefix(
            AnchorState(*(g[gi] for g in got[na:2 * na])), n)
        adam_v = _host_prefix(
            AnchorState(*(g[gi] for g in got[2 * na:3 * na])), n)
        stats_h = _stats_host(TrainStats(*(g[gi] for g in got[3 * na:])),
                              n, k)
        res = adjust_anchors(anchors, adam_m, adam_v, stats_h, model_cfg,
                             opt, voxel_size, rng)
        resort_by_z(anchors, adam_m, adam_v, stats_h, k)
        per.append((anchors, adam_m, adam_v, stats_h, res.n_active))
        results.append(res)

    n_max = max(r.n_active for r in results)
    cap = capacity if capacity >= n_max else _round_up(
        int(n_max * 1.5), 1024)
    anchors, adam_m, adam_v, stats_h, n_new = per[mesh.dp_index]
    new_anchors, new_m, new_v, new_stats = _pad_training(
        anchors, adam_m, adam_v, stats_h, n_new, cap, k,
        state.anchors.anchor.device)
    state = state._replace(anchors=new_anchors, n_active=n_new)
    adam = AdamState(m=(new_m, adam.m[1]), v=(new_v, adam.v[1]),
                     step=adam.step)
    return state, adam, new_stats, results, cap


class GopRankFitter(GOPFitter):
    """This dp rank's GOP of the fan-out: a single-GPU ``GOPFitter``
    (``mesh`` None: the state is the GOP's whole, and every file and
    evaluation is the sequential run's) that replays the draws JAX's
    ``fit_gops`` takes from one generator across all GOPs.  ``datasets``
    holds every GOP; the others give only their geometry and frame count.

    * Init: the initial point clouds GOP by GOP from ``default_rng(seed)``
      (GOPFitter draws this rank's), the model of GOP ``gi`` from seed
      ``seed + gi`` (JAX's ``PRNGKey(seed + gi)``; the noise generator
      too), and ``window_cap`` the max over GOPs.
    * Each step: one frame draw for every GOP, this rank keeping its own.
    * Densify epochs: ``gop_densify_epoch`` (every GOP's draws, a shared
      capacity), then ``window_cap`` grows to the max over GOPs.

    The fan-out's own mesh is ``gop_mesh``; ``gi`` is this rank's GOP."""

    def __init__(self, mesh: Mesh, cfg, datasets, seed: int = 0,
                 log_fn=None, device=None):
        from gsvc_tpu_torch.framecube.pointcloud import init_point_cloud
        from gsvc_tpu_torch.models.gaussians import init_anchor_arrays

        g = len(datasets)
        if g != mesh.size("dp"):
            raise ValueError(f"need dp == n_gops ({g}), mesh has "
                             f"dp={mesh.size('dp')}")
        if mesh.size("sp") != 1:
            raise ValueError("the GOP fan-out shards over dp only; sp must "
                             "be 1")
        self.gop_mesh, self.gi = mesh, mesh.dp_index
        n = cfg.optimization.init_anchor_num
        rng = np.random.default_rng(seed)

        def cloud(ds):
            return init_point_cloud(ds.x_min, ds.y_min, ds.z_min, n=n,
                                    rng=rng)

        clouds = [cloud(ds) for ds in datasets[:self.gi]]
        super().__init__(cfg, datasets[self.gi], seed=seed + self.gi,
                         log_fn=log_fn, device=device, rng=rng)
        clouds += [None] + [cloud(ds) for ds in datasets[self.gi + 1:]]
        self.gop_frames = [ds.num_frames for ds in datasets]
        self.gop_frame_zs = [np.array([(j - ds.num_frames / 2) / ds.scale
                                       for j in range(ds.num_frames)],
                                      np.float32) for ds in datasets]
        for i, pts in enumerate(clouds):
            if pts is None:
                continue
            fields, n_i = init_anchor_arrays(self.gcfg, pts, self.capacity,
                                             cfg.model.voxel_size)
            self.window_cap = max(self.window_cap, compute_window_cap(
                fields["anchor"][:, 2], n_i, self.gop_frame_zs[i],
                self.gcfg.threshold))
        # the densify epochs' voxel size as JAX's fit_gops takes it
        self.voxel_size = cfg.model.voxel_size or 0.001
        self._build_step()

    def _draw_frame(self, n_frames: int) -> int:
        return [int(self.rng.integers(0, max(c - 1, 1)))
                for c in self.gop_frames][self.gi]

    def _densify(self):
        k = self.gcfg.n_offsets
        self.state, self.adam, self.stats, res, cap = gop_densify_epoch(
            self.state, self.adam, self.stats, self.gop_mesh,
            self.cfg.model, self.cfg.optimization, self.voxel_size,
            self.rng, k, self.capacity)
        rebuild = cap != self.capacity
        self.capacity = cap
        zs = _gather(self.state.anchors.anchor[:, 2], self.gop_mesh,
                     "dp").cpu().numpy()
        new_window = max(compute_window_cap(
            zs[i], r.n_active, self.gop_frame_zs[i], self.gcfg.threshold)
            for i, r in enumerate(res))
        if new_window > self.window_cap:
            self.window_cap = new_window
            rebuild = True
        if rebuild:
            self._build_step()
        self.log(f"densify of every GOP -> {[r.n_active for r in res]} "
                 f"(cap {self.capacity})")
        return res[self.gi]


def fit_gops(mesh: Mesh, cfg, datasets, iterations: Optional[int] = None,
             seed: int = 0, log_fn=None, device=None):
    """Fit one independent model per GOP, one GOP a dp rank
    (``GopRankFitter``; the library-level counterpart of cli/train.py's
    sequential ``_train_segmented`` loop).  ``datasets``: one
    FrameCubeDataset per GOP, equal frame geometry; ``len(datasets)``
    must equal dp.  Returns (states, reports): every GOP's final
    ModelState and loss/psnr history (every 50 iterations and the last),
    on every rank."""
    fitter = GopRankFitter(mesh, cfg, datasets, seed=seed, log_fn=log_fn,
                           device=device)
    rep = fitter.fit(iterations, log_every=50)
    mine = [{k: h[k] for k in ("iter", "loss", "psnr")}
            for h in rep.history]
    if not mine or mine[-1]["iter"] != rep.iterations:
        mine.append({"iter": rep.iterations, "loss": rep.loss,
                     "psnr": rep.psnr})
    reports = [None] * len(datasets)
    dist.all_gather_object(reports, mine, group=mesh.groups["dp"])
    return unstack_states(stack_states(fitter.state, mesh),
                          len(datasets)), reports
