"""FedHAP's hierarchical round as collectives over ``torch.distributed``
(port of ``repro.core.mesh_round``).

The port runs SPMD: every rank is one process holding its own shard of
the satellite axis, every rank runs the same numpy plan, and the ranks
meet only in the collectives that the reference's ``shard_map`` bodies
use. The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
the reference's axis names (``("data", "model")`` or ``("pod", "data",
"model")``); the collectives map as:

- ``jax.lax.psum(x, axes)`` -> ``dist.all_reduce`` over the axis group
  (for ``("data", "pod")`` the flattened pod x data group, one
  reduction); a tree goes as one flat f32 buffer;
- ``jax.lax.ppermute(x, axis, perm)`` -> one ``dist.batch_isend_irecv``
  per hop over the global ranks of the axis; a pair whose source is its
  own destination (a ring of one satellite) is a local copy;
- ``jax.lax.all_gather(x, "data")`` -> ``dist.all_gather_into_tensor``;
- ``jax.lax.axis_index(a)`` -> ``mesh.get_local_rank(a)``, a host int,
  so the reference's ``where`` on it is a host branch here.

The backend follows the device: gloo for CPU tensors, NCCL for CUDA
tensors; a tensor offered to a group of the other backend raises.

Each of the three primitives reports its collective's kind and output
bytes (the JAX package's ``parse_collective_bytes`` payload) to the
dry run's meter when one is installed (``kernels/meter.py``). On meta
tensors, which only the dry run passes (``launch/dryrun.py``), they
return empty tensors of the result's shape and touch no process group;
any other tensor goes through the group as it always does.

Three rounds, as in the reference:

- ``fedhap`` (faithful): K-hop rings per orbit performing the Eq.-14
  partial folds at each invisible hop (echoing the global model
  alongside when ``ship_global_echo`` is set: the bytes are the point),
  the masked Eq.-16 collection at each pod's HAP, the sink->source HAP
  chain over the pod axis and the source HAP's broadcast back; Eq.-15
  gating keeps the old replicas when any satellite is uncovered. The
  reference adds ``0.0 * echo_probe`` to the upload mass only so that
  XLA keeps the echo's sends; eager mode cannot drop them, so the port
  leaves the term out (the tests hold the round with the echo equal,
  bit for bit, to the round without it).
- ``fedhap_fused`` (beyond-paper): the same update from closed-form
  chain weights (:func:`chain_stats_torch`, a torch twin of
  :func:`repro_torch.core.weights.chain_stats` on the all-gathered
  vectors, so no value goes to the host), then ONE weighted all-reduce
  of the model: :func:`sharded_fold`.
- ``fedavg``: the star-topology baseline (a weighted all-reduce).

Over a ``model`` axis larger than 1 each model index runs its own copy
of the round over its own data (and pod) group. The round is leafwise
on the satellite's weights, so with trailing dims sharded over ``model``
(the reference's ``model_specs``, ``models/sharding.py``) each rank runs
it on its own contiguous slice of every leaf, as the reference's
``shard_map`` body sees its block; :func:`sharded_fold` folds those
slices. With no ``model_specs`` the leaves replicate over ``model``.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.dissemination import (
    ConstellationMeshMap,
    hap_chain_down,
    hap_chain_up,
)
from repro_torch.core.weights import PARTIAL_MODES
from repro_torch.kernels import meter
from repro_torch.kernels.ops import fold_stacked_tree

#: Alignment of every leaf inside a packed flat buffer, in f32 elements
#: (64 bytes: the CPU allocator's alignment, a multiple of the fold
#: kernel's 16), so unpacked views are aligned like fresh tensors.
PACK_ALIGN = 16


@dataclasses.dataclass(frozen=True)
class FedRoundConfig:
    cmap: ConstellationMeshMap = ConstellationMeshMap()
    partial_mode: str = "paper"        # paper | exact   (Eq. 14 gamma)
    orbit_weighting: str = "paper"     # paper | global  (Eq. 16)
    hap_ring: bool = True              # faithful pod chain vs pod psum
    ship_global_echo: bool = True      # ring hops carry w^beta too (§III-B2)


# ===================================================================
# The mesh's collectives, by axis name.
def _require_mesh(mesh: Any, what: str) -> None:
    """Raise ``ValueError`` unless ``mesh`` is a ``DeviceMesh`` over an
    initialised process group."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"{what} runs over torch.distributed, which is not initialised: "
            f"start one process per rank (torchrun, then "
            f"repro_torch.launch.mesh.init_ranks) and pass a DeviceMesh")
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise ValueError(f"{what} takes a torch.distributed DeviceMesh, "
                         f"got {type(mesh).__name__}")


def _axis_ranks(mesh: Any, axes: Sequence[str]) -> list[list[int]]:
    """The global ranks of every group spanning ``axes`` (in the mesh's
    axis order), one list per index of the other axes."""
    names = list(mesh.mesh_dim_names)
    dims = sorted(names.index(a) for a in axes)
    rest = [d for d in range(len(names)) if d not in dims]
    grid = mesh.mesh.permute(*rest, *dims)
    return grid.reshape(-1, grid[(0,) * len(rest)].numel()).tolist()


def axis_group(mesh: Any, axes: Sequence[str]):
    """The process group of this rank over ``axes``: the mesh's own group
    for one axis; for several, the flattened group of all of them (made
    once per mesh, collectively: every rank must reach the first call
    for a given ``axes``, as SPMD code does)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_fed_groups", {})
    key = tuple(sorted(axes))
    if key not in cache:
        cache[key], _ = dist.new_subgroups_by_enumeration(
            _axis_ranks(mesh, axes))
    return cache[key]


def _check_backend(group: Any, x: torch.Tensor) -> None:
    """A tensor goes only to a group of its device's backend: nothing
    stages through the host and nothing switches backend."""
    backend = dist.get_backend(group)
    want = {"cuda": "nccl", "cpu": "gloo"}.get(x.device.type)
    if backend != want:
        raise ValueError(
            f"a {x.device.type} tensor offered to a {backend} process group "
            f"(the {x.device.type} backend is {want}); start the ranks with "
            f"the backend of the device the round runs on")


def _peer(mesh: Any, axis: str, index: int) -> int:
    """Global rank of the rank at this rank's coordinate with ``axis`` set
    to ``index``."""
    coord = list(mesh.get_coordinate())
    coord[list(mesh.mesh_dim_names).index(axis)] = index
    return int(mesh.mesh[tuple(coord)])


def _layout(tree: Mapping[str, torch.Tensor]) -> tuple[list, int]:
    """``(key, shape, offset)`` of each leaf in a packed flat buffer, and
    the buffer's length: offsets aligned to :data:`PACK_ALIGN`."""
    out, total = [], 0
    for k, x in tree.items():
        out.append((k, tuple(x.shape), total))
        total += -(-x.numel() // PACK_ALIGN) * PACK_ALIGN
    return out, total


def _pack(tree: Mapping[str, torch.Tensor]) -> tuple[torch.Tensor, list]:
    """One flat f32 buffer holding every leaf (f32 leaves only)."""
    layout, total = _layout(tree)
    first = next(iter(tree.values()))
    flat = torch.zeros(total, dtype=torch.float32, device=first.device)
    for (k, _, off), x in zip(layout, tree.values()):
        if x.dtype != torch.float32:
            raise TypeError(f"packed leaves are f32; {k} is {x.dtype}")
        flat[off:off + x.numel()].copy_(x.reshape(-1))
    return flat, layout


def _unpack(flat: torch.Tensor, layout: list) -> dict:
    """Views of ``flat``'s leaves (see :func:`_pack`)."""
    out = {}
    for k, shape, off in layout:
        out[k] = flat[off:off + math.prod(shape)].view(shape)
    return out


def _shared_base(tree: Mapping[str, torch.Tensor]) -> Optional[torch.Tensor]:
    """The one flat buffer every leaf is a view of, if there is one (the
    fold kernel returns its leaves so, in a buffer of their own): reducing
    it in place reduces every leaf with no copy."""
    leaves = list(tree.values())
    base = leaves[0]._base
    if base is None or base.dim() != 1 or not base.is_contiguous():
        return None
    if any(x._base is not base for x in leaves):
        return None
    return base


def psum_(x: torch.Tensor, mesh: Any, axes: Sequence[str]) -> torch.Tensor:
    """In-place sum of ``x`` over ``axes`` (``jax.lax.psum``); returns
    ``x``."""
    meter.report_collective("all-reduce", x.numel() * x.element_size())
    if x.device.type == "meta":
        return x
    group = axis_group(mesh, axes)
    _check_backend(group, x)
    dist.all_reduce(x, group=group)
    return x


def psum(x: torch.Tensor, mesh: Any, axes: Sequence[str]) -> torch.Tensor:
    """``jax.lax.psum`` of a tensor: a new tensor, ``x`` untouched."""
    return psum_(x.clone(), mesh, axes)


def psum_tree(tree: Mapping[str, torch.Tensor], mesh: Any,
              axes: Sequence[str]) -> dict:
    """``psum`` of every f32 leaf as ONE all-reduce of a packed copy;
    returns views of it (the leaves given are not written)."""
    flat, layout = _pack(tree)
    return _unpack(psum_(flat, mesh, axes), layout)


def all_gather(x: torch.Tensor, mesh: Any, axis: str) -> torch.Tensor:
    """``jax.lax.all_gather`` of a 0-d tensor over one axis: the ``(n,)``
    vector of every rank's value, in axis order."""
    n = mesh.shape[list(mesh.mesh_dim_names).index(axis)]
    meter.report_collective("all-gather", n * x.element_size())
    if x.device.type == "meta":
        return x.new_empty(n)
    group = axis_group(mesh, (axis,))
    _check_backend(group, x)
    out = x.new_empty(dist.get_world_size(group))
    with warnings.catch_warnings():
        # torch >= 2.12 renames it all_gather_single; the call is the same.
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x.reshape(1).contiguous(),
                                    group=group)
    return out


def ppermute_tree(tree: Mapping[str, torch.Tensor], mesh: Any, axis: str,
                  perm: Sequence[tuple[int, int]]) -> dict:
    """``jax.lax.ppermute`` of a tree of f32 leaves over ``axis``: this
    rank sends its leaves to the destination its index maps to and takes
    those of the source that maps to it, as one packed buffer in one
    ``batch_isend_irecv``; a rank no pair maps to receives zeros. A pair
    (i, i) is a local copy."""
    me = mesh.get_local_rank(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if dst == [me] and src == [me]:
        return dict(tree)
    flat, layout = _pack(tree)
    meter.report_collective("collective-permute",
                            flat.numel() * flat.element_size())
    recv = torch.zeros_like(flat)
    if flat.device.type == "meta":
        return _unpack(recv, layout)
    _check_backend(axis_group(mesh, (axis,)), flat)
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, flat, _peer(mesh, axis, dst[0])))
    if src:
        ops.append(dist.P2POp(dist.irecv, recv, _peer(mesh, axis, src[0])))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return _unpack(recv, layout)


# ===================================================================
def _ring_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1, keepdim=True)`` in numpy's order for a ring of K <= 128
    (its pairwise sum: one by one below 8 terms, else 8 running partial
    sums combined as ((0+1)+(2+3))+((4+5)+(6+7)), then the tail), so the
    twin's orbit mass is bit-equal to ``chain_stats``'."""
    k = x.shape[-1]
    if k > 128:
        raise ValueError(f"ring of {k} satellites; the twin's sum follows "
                         f"numpy's order up to 128")
    if k < 8:
        out = x[..., :1]
        for i in range(1, k):
            out = out + x[..., i:i + 1]
        return out
    whole = k - k % 8
    r = [x[..., j:j + 1] for j in range(8)]
    for i in range(8, whole, 8):
        r = [r[j] + x[..., i + j:i + j + 1] for j in range(8)]
    out = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for i in range(whole, k):
        out = out + x[..., i:i + 1]
    return out


def chain_stats_torch(visible: torch.Tensor, sizes: torch.Tensor,
                      partial_mode: str = "paper"
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`repro_torch.core.weights.chain_stats` on device tensors:
    the same ring walk (a static unroll over the ring size K, ``roll``
    and ``where``, no data-dependent control flow and no host read), op
    for op. ``visible``/``sizes`` are ``(..., K)``; returns ``(lam,
    seg_mass)`` in ``sizes``' dtype."""
    if partial_mode not in PARTIAL_MODES:
        raise ValueError(f"unknown partial aggregation mode: {partial_mode}")
    visible = visible.to(torch.bool)
    k = visible.shape[-1]
    m_orbit = _ring_sum(sizes)
    safe_orbit = torch.where(m_orbit > 0, m_orbit, 1.0)

    suffix = torch.ones_like(sizes)
    seg = sizes
    terminated = torch.zeros_like(visible)
    for step in range(1, k):
        nxt_vis = torch.roll(visible, -step, dims=-1)
        nxt_sz = torch.roll(sizes, -step, dims=-1)
        active = (~terminated) & (~nxt_vis)
        if partial_mode == "paper":
            suffix = torch.where(active,
                                 suffix * (1.0 - nxt_sz / safe_orbit),
                                 suffix)
        seg = torch.where(active, seg + nxt_sz, seg)
        terminated = terminated | nxt_vis

    prefix = torch.zeros_like(sizes)
    back_done = visible
    for step in range(1, k):
        prv_vis = torch.roll(visible, step, dims=-1)
        prv_sz = torch.roll(sizes, step, dims=-1)
        prefix = torch.where(back_done, prefix, prefix + prv_sz)
        back_done = back_done | prv_vis
    seg_mass = prefix + seg

    if partial_mode == "paper":
        lam = torch.where(visible, 1.0, sizes / safe_orbit) * suffix
    else:
        safe_seg = torch.where(seg_mass > 0, seg_mass, 1.0)
        lam = sizes / safe_seg

    any_vis = visible.any(dim=-1, keepdim=True)
    lam = torch.where(any_vis, lam, 0.0)
    seg_mass = torch.where(any_vis, seg_mass, 0.0)
    return lam, seg_mass


# ===================================================================
def sharded_fold(stacked_local: Mapping[str, torch.Tensor],
                 weights_local: Any, mesh: Any,
                 axes: Sequence[str] = ("data",)) -> dict:
    """The production round's collective aggregation tail, for any
    per-rank satellite shard: the local weighted fold of the ``(S_local,
    ...)`` stacked shard on f32 rows through
    :func:`repro_torch.kernels.ops.fold_stacked_tree` (the ``fedagg``
    kernel on CUDA, the plain fold on the CPU), then ONE all-reduce over
    ``axes``: on the card in place on the kernel's flat output buffer.

    With one satellite per rank this is ``fedhap_fused``'s tail; with
    larger shards it is the simulator's sharded fold
    (:class:`repro_torch.sim.executor.FusedExecutor`): launch/ and sim/
    share this one code path. Zero-weight rows (padded dead satellites)
    add exactly zero in both fold backends."""
    _require_mesh(mesh, "sharded_fold")
    part = fold_stacked_tree(
        {k: x.to(torch.float32) for k, x in stacked_local.items()},
        weights_local)
    base = _shared_base(part)
    if base is None:
        return psum_tree(part, mesh, axes)
    psum_(base, mesh, axes)
    return part


# ===================================================================
class _Ctx:
    """What a round body needs of its mesh: axis indices (host ints) and
    the sum axes of the satellite dim."""

    def __init__(self, mesh: Any, multi_pod: bool):
        self.mesh = mesh
        self.multi_pod = multi_pod
        self.axes = ("pod", "data") if multi_pod else ("data",)
        self.data_index = mesh.get_local_rank("data")
        self.pod_index = mesh.get_local_rank("pod") if multi_pod else 0


def _squeeze0(tree: Mapping[str, torch.Tensor]) -> dict:
    return {k: x[0] for k, x in tree.items()}


def _expand0(tree: Mapping[str, torch.Tensor]) -> dict:
    return {k: x[None] for k, x in tree.items()}


def _select(pred: torch.Tensor, a: Mapping[str, torch.Tensor],
            b: Mapping[str, torch.Tensor]) -> dict:
    """``where(pred, a, b)`` leafwise with a 0-d bool ``pred``."""
    return {k: torch.where(pred, x, b[k]) for k, x in a.items()}


def _ring_phase(w: dict, m_self: torch.Tensor, vis_self: torch.Tensor,
                m_orbit: torch.Tensor, cfg: FedRoundConfig, ctx: _Ctx):
    """Intra-orbit dissemination + Eq.-14 partial aggregation. Returns
    ``(upload, up_mass, up_count, has_upload)``: the partial-global model
    delivered to this slot if it is a visible satellite."""
    k = cfg.cmap.sats_per_orbit
    perm = cfg.cmap.ring_permutation(+1)
    w32 = {n: x.to(torch.float32) for n, x in w.items()}
    zero = m_self.new_zeros(())
    false = torch.zeros((), dtype=torch.bool, device=m_self.device)

    outbox, out_mass = w32, m_self
    out_count = m_self.new_ones(())
    ready = vis_self
    received = false
    upload = {n: torch.zeros_like(x) for n, x in w32.items()}
    up_mass, up_count, has_upload = zero, zero, false
    # The paper's hops also carry the global model w^beta (resident at
    # every rank already: shipping it is pure communication, reproduced
    # for byte-faithfulness when ship_global_echo is set).
    echo = w32
    for _ in range(k):
        msg = {f"box/{n}": x for n, x in outbox.items()}
        if cfg.ship_global_echo:
            msg.update({f"echo/{n}": x for n, x in echo.items()})
        msg.update(mass=out_mass, count=out_count,
                   ready=ready.to(torch.float32))
        got = ppermute_tree(msg, ctx.mesh, "data", perm)
        inbox = {n: got[f"box/{n}"] for n in w32}
        if cfg.ship_global_echo:
            echo = {n: got[f"echo/{n}"] for n in w32}
        in_mass, in_count = got["mass"], got["count"]
        in_ready = got["ready"] > 0.5

        accept = in_ready & ~received
        received = received | accept
        # invisible satellite: fold own model (Eq. 14) and forward.
        if cfg.partial_mode == "paper":
            gamma = m_self / m_orbit
        else:  # exact running weighted mean
            gamma = m_self / (in_mass + m_self)
        folded = {n: (1.0 - gamma) * inbox[n] + gamma * w32[n] for n in w32}
        take_fold = accept & ~vis_self
        outbox = _select(take_fold, folded, outbox)
        out_mass = torch.where(take_fold, in_mass + m_self, out_mass)
        out_count = torch.where(take_fold, in_count + 1.0, out_count)
        ready = take_fold
        # visible satellite: the chain terminates here; upload to the HAP.
        take_up = accept & vis_self
        upload = _select(take_up, inbox, upload)
        up_mass = torch.where(take_up, in_mass, up_mass)
        up_count = torch.where(take_up, in_count, up_count)
        has_upload = has_upload | take_up
    return upload, up_mass, up_count, has_upload


def _hap_combine(contrib: dict, cfg: FedRoundConfig, ctx: _Ctx) -> dict:
    """Collect the per-slot contributions (already Eq.-16 weighted) at the
    HAP tier and produce the new global model on every rank."""
    if not ctx.multi_pod or not cfg.hap_ring:
        return psum_tree(contrib, ctx.mesh, ctx.axes)
    # Faithful multi-pod path: per-pod HAP sum over `data`, the
    # sink -> source chain over `pod` (§III-B3), then the source -> sink
    # broadcast of the aggregate (§III-B1).
    pod_sum = psum_tree(contrib, ctx.mesh, ("data",))
    n_pods = cfg.cmap.n_pods
    p_idx = ctx.pod_index
    # token passing: msg arrives at pod p carrying the sum of pods > p.
    msg = {n: torch.zeros_like(x) for n, x in pod_sum.items()}
    down = hap_chain_down(n_pods) + [(0, n_pods - 1)]  # ring-closed perm
    for step in range(n_pods - 1):
        if p_idx == n_pods - 1 - step:
            msg = {n: m + pod_sum[n] for n, m in msg.items()}
        msg = ppermute_tree(msg, ctx.mesh, "pod", down)
    total = ({n: x + msg[n] for n, x in pod_sum.items()} if n_pods > 1
             else pod_sum)
    # `total` is right at the source (pod 0); broadcast source -> sink.
    up = hap_chain_up(n_pods) + [(n_pods - 1, 0)]
    glob = (total if p_idx == 0
            else {n: torch.zeros_like(x) for n, x in total.items()})
    for step in range(n_pods - 1):
        recv = ppermute_tree(glob, ctx.mesh, "pod", up)
        if p_idx == step + 1:
            glob = recv
    return glob


def _scalars(sizes_shard: torch.Tensor, visible_shard: torch.Tensor):
    m_self = sizes_shard[0].to(torch.float32)
    vis_self = visible_shard[0].to(torch.bool)
    return m_self, vis_self


def _round_body(w_shard: dict, sizes_shard: torch.Tensor,
                visible_shard: torch.Tensor, cfg: FedRoundConfig,
                ctx: _Ctx):
    """The faithful round on this rank's ``(1, ...)`` satellite shard."""
    w = _squeeze0(w_shard)
    m_self, vis_self = _scalars(sizes_shard, visible_shard)
    k = cfg.cmap.sats_per_orbit
    my_orbit = ctx.data_index // k

    # Per-orbit data mass: gather the pod's sizes, sum my orbit's run.
    sizes_all = all_gather(m_self, ctx.mesh, "data")            # (D,)
    m_orbit = sizes_all[my_orbit * k:(my_orbit + 1) * k].sum()

    upload, up_mass, up_count, has_up = _ring_phase(
        w, m_self, vis_self, m_orbit, cfg, ctx)

    # Eq. 16 weighting of each upload.
    n_orbits_total = cfg.cmap.n_orbits * (cfg.cmap.n_pods
                                          if ctx.multi_pod else 1)
    if cfg.orbit_weighting == "paper":
        weight = up_mass / m_orbit / n_orbits_total
    else:
        weight = up_mass / psum(m_self, ctx.mesh, ctx.axes)
    weight = torch.where(has_up, weight, 0.0)
    contrib = {n: x.to(torch.float32) * weight for n, x in upload.items()}

    # Eq. 15 gating: every satellite covered exactly once?
    covered = psum(torch.where(has_up, up_count, 0.0), ctx.mesh, ctx.axes)
    n_sats = cfg.cmap.sats_per_pod * (cfg.cmap.n_pods
                                      if ctx.multi_pod else 1)
    gate = covered >= n_sats - 0.5

    glob = _hap_combine(contrib, cfg, ctx)
    # The new global into every replica; gated, keep the current replicas
    # (aggregation rescheduled: paper Alg. 1 line 18).
    new_w = {n: torch.where(gate, glob[n].to(old.dtype), old)
             for n, old in w.items()}
    stats = {"gate": gate.to(torch.float32), "covered": covered,
             "upload_mass": psum(up_mass, ctx.mesh, ctx.axes)}
    return _expand0(new_w), stats


def _fedavg_body(w_shard: dict, sizes_shard: torch.Tensor,
                 visible_shard: torch.Tensor, ctx: _Ctx):
    """Star-topology FedAvg: weighted all-reduce over all satellites.
    Visibility is ignored (classical FedAvg assumes a reachable PS)."""
    w = _squeeze0(w_shard)
    m_self, _ = _scalars(sizes_shard, visible_shard)
    m_total = psum(m_self, ctx.mesh, ctx.axes)
    scale = m_self / m_total
    glob = psum_tree({n: x.to(torch.float32) * scale for n, x in w.items()},
                     ctx.mesh, ctx.axes)
    new_w = {n: glob[n].to(old.dtype) for n, old in w.items()}
    n_sats = dist.get_world_size(axis_group(ctx.mesh, ctx.axes))
    stats = {"gate": m_self.new_ones(()),
             "covered": m_self.new_full((), float(n_sats)),
             "upload_mass": m_total}
    return _expand0(new_w), stats


def _fused_body(w_shard: dict, sizes_shard: torch.Tensor,
                visible_shard: torch.Tensor, cfg: FedRoundConfig,
                ctx: _Ctx):
    """Beyond-paper fused round: the closed-form per-satellite weight,
    one weighted all-reduce. Per-satellite weight mu_x = (m_seg / m_l) *
    lam_x / L (paper orbit weighting), with lam_x the Eq.-14 chain weight
    of x in its segment and m_seg the segment's mass, from two tiny
    all-gathers and the torch chain twin."""
    m_self, vis_self = _scalars(sizes_shard, visible_shard)
    k = cfg.cmap.sats_per_orbit
    my_orbit, my_slot = divmod(ctx.data_index, k)

    sizes_all = all_gather(m_self, ctx.mesh, "data")            # (D,)
    vis_all = all_gather(vis_self.to(torch.float32), ctx.mesh, "data")
    run = slice(my_orbit * k, (my_orbit + 1) * k)
    orbit_sizes, orbit_vis = sizes_all[run], vis_all[run] > 0.5
    m_orbit = orbit_sizes.sum()

    lam_vec, seg_vec = chain_stats_torch(orbit_vis, orbit_sizes,
                                         cfg.partial_mode)
    lam, seg_mass = lam_vec[my_slot], seg_vec[my_slot]
    orbit_has_vis = orbit_vis.any()

    n_orbits_total = cfg.cmap.n_orbits * (cfg.cmap.n_pods
                                          if ctx.multi_pod else 1)
    if cfg.orbit_weighting == "paper":
        mu = seg_mass / m_orbit * lam / n_orbits_total
    else:
        mu = seg_mass / psum(m_self, ctx.mesh, ctx.axes) * lam

    n_ranks = dist.get_world_size(axis_group(ctx.mesh, ctx.axes))
    orbits_seen = psum(torch.where(orbit_has_vis, 1.0, 0.0).to(m_self),
                       ctx.mesh, ctx.axes)
    gate = orbits_seen >= n_ranks - 0.5

    # The weighted all-reduce tail is the shared sharded fold (the
    # simulator's per-shard aggregation, S_local == 1 here).
    glob = sharded_fold(w_shard, mu[None], ctx.mesh, ctx.axes)
    new_w = {n: torch.where(gate, glob[n].to(old.dtype), old)
             for n, old in _squeeze0(w_shard).items()}
    stats = {"gate": gate.to(torch.float32),
             "covered": orbits_seen * k,
             "upload_mass": psum(torch.where(mu > 0, m_self, 0.0),
                                 ctx.mesh, ctx.axes)}
    return _expand0(new_w), stats


def build_round(mesh: Any, cfg: FedRoundConfig, param_tree_example: Any,
                model_specs: Any = None, kind: str = "fedhap"):
    """Returns ``round_fn(params_local, sizes_local, visible_local) ->
    (params_local, stats)``: the chosen round on ``mesh``, run by every
    rank on its own shard, as the reference's ``shard_map`` body sees it.

    ``params_local`` leaves are ``(1, ...)``: this rank's satellite, the
    one at global index ``pod * sats_per_pod + data`` of the reference's
    ``(S, ...)`` stack; ``sizes_local`` and ``visible_local`` are its
    ``(1,)`` entries, on the params' device. ``stats`` (``gate``,
    ``covered``, ``upload_mass``) are 0-d device tensors, the same on
    every rank. ``model_specs`` (trailing specs, leaf by leaf) shard the
    leaves over ``model``: ``params_local`` then holds this rank's slice
    of each (``sharding.shard_params``), and the round runs on the
    slices; the round itself is the same for any specs.
    ``param_tree_example`` is the reference's argument for its partition
    specs; the port needs none of it. Raises ``ValueError`` outside a
    process group or when the mesh cannot tile ``cfg.cmap``."""
    del param_tree_example, model_specs
    _require_mesh(mesh, "build_round")
    names = tuple(mesh.mesh_dim_names)
    if "data" not in names:
        raise ValueError(f"build_round needs a 'data' axis; mesh axes "
                         f"{names}")
    multi_pod = "pod" in names
    cfg.cmap.validate_mesh(dict(zip(names, mesh.shape)))
    ctx = _Ctx(mesh, multi_pod)
    axis_group(mesh, ctx.axes)          # made here, on every rank at once
    if kind == "fedavg":
        def body(w, s, v):
            return _fedavg_body(w, s, v, ctx)
    elif kind == "fedhap":
        def body(w, s, v):
            return _round_body(w, s, v, cfg, ctx)
    elif kind == "fedhap_fused":
        def body(w, s, v):
            return _fused_body(w, s, v, cfg, ctx)
    else:
        raise ValueError(kind)

    def round_fn(params_local: Mapping[str, torch.Tensor],
                 sizes_local: torch.Tensor, visible_local: torch.Tensor):
        with torch.no_grad():
            return body(dict(params_local), sizes_local, visible_local)

    return round_fn


__all__ = ["FedRoundConfig", "PACK_ALIGN", "all_gather", "axis_group",
           "build_round", "chain_stats_torch", "ppermute_tree",
           "psum", "psum_", "psum_tree", "sharded_fold"]
