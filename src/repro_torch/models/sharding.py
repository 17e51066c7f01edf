"""Tensor parallelism over the mesh's ``model`` axis, as explicit
collectives.

The JAX package shards every leaf's trailing dims over ``model`` by its
partition spec (``ParamDef.axes``, sanitized by
``launch/specs.sanitize_specs``) and leaves the rest to GSPMD. The port
has no GSPMD: a rank holds its own shard of each leaf and the layers say
where the ranks meet. This module holds what they share:

- :class:`ModelAxis`: the ``model`` dim's process group of a
  ``DeviceMesh``, its size ``m`` and this rank's index, and each leaf's
  sanitized spec (a tuple of axis names, the port's ``PartitionSpec``);
- the autograd-aware collectives, Megatron-LM's pair and a gather:
  :meth:`ModelAxis.enter` (identity forward, all-reduce of the gradient:
  where a replicated activation or leaf feeds a rank's local heads,
  channels or experts), :meth:`ModelAxis.exit` (all-reduce forward,
  identity backward: a row-parallel product's partial sums) and
  :meth:`ModelAxis.gather` (all-gather along a dim forward, the rank's
  slice of the gradient backward: a leaf or an activation that every
  rank then uses whole, so its gradient is the same on every rank);
- :func:`shard_params` / :func:`gather_params`: a full param tree (numpy
  or torch, the JAX package's params carried over) as this rank's
  shards, and the shards gathered whole again.

A rank's shard of a leaf is the ``r``-th of ``m`` equal chunks of the dim
its spec names ``model``, copied contiguous (``fedagg_leaves`` packs
aligned buffers: a strided view of the full leaf will not do). A leaf in
:data:`FUSED` concatenates equal parts along that dim (Mamba's
``in_proj``, ``x | z``): its shard is the ``r``-th chunk of each part,
concatenated, so its local ``x`` and ``z`` channels match ``conv_w``'s
shard; :func:`gather_params` and :meth:`ModelAxis.gather` invert that.

How a layer uses its leaves (``models/{layers,attention,moe,ssm,rwkv}``):
a layer runs on its shards when every leaf of its parallel form is
sharded on the dim that form expects (:data:`WANT` in each module) and
its heads (channels, experts) divide by ``m``; otherwise it gathers its
sharded leaves at use and runs whole on every rank, so no shard boundary
falls inside a head. A leaf that ``sanitize_specs`` moved to another dim
than its spec names (whisper-small's odd vocab) is gathered once per
forward (:meth:`ModelAxis.prepare`). Each gathered leaf is recorded in
:attr:`ModelAxis.gathered`.

On meta tensors (the dry run, ``launch/dryrun.py``) the collectives move
nothing and touch no process group: they report their kind and output
bytes to the meter (``kernels/meter.py``) and return a meta tensor of the
result's shape.
"""
from __future__ import annotations

import warnings
from typing import Any, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels import meter

MODEL = "model"

#: Leaves made of equal parts concatenated along their sharded dim, by
#: leaf name: each part is sharded on its own (see the module's text).
#: The zoo has one: Mamba's ``in_proj`` ``(d, 2·d_inner)``,
#: ``x | z`` (jamba-v0.1-52b).
FUSED = {"in_proj": 2}


def fused_parts(key: str) -> int:
    """How many equal parts the leaf ``key`` (a ``/``-joined path) is
    made of along its sharded dim: 1 unless its name is in
    :data:`FUSED`."""
    return FUSED.get(key.rsplit("/", 1)[-1], 1)


def model_dim(spec: Optional[tuple]) -> Optional[int]:
    """The dim a spec shards over ``model``, or None."""
    if spec is None:
        return None
    for i, ax in enumerate(spec):
        if ax == MODEL:
            return i
    return None


def local_shape(shape: Iterable[int], spec: Optional[tuple], m: int,
                lead: int = 0) -> tuple:
    """A leaf's shard shape on one of ``m`` ranks; ``spec`` is trailing
    (``lead`` leading dims, e.g. the satellite dim, are not in it)."""
    shape = list(shape)
    d = model_dim(spec)
    if d is not None:
        shape[lead + d] //= m
    return tuple(shape)


def mesh_sizes(mesh: Any) -> dict:
    """``{axis: size}`` of a ``DeviceMesh`` or of such a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def sanitize_specs(example: Mapping[str, Any], specs: Mapping[str, tuple],
                   mesh: Any) -> dict:
    """Argument shardings must divide evenly. Where a dim sharded over
    ``model`` is not divisible by the axis size (51865-row vocab tables,
    8-KV-head caches, ...), move the ``model`` sharding to the first
    unsharded divisible dim, else drop it: the reference's rule, leaf by
    leaf. ``example`` maps each key to a tensor or a ParamDef (anything
    with ``.shape``; a Python int is 0-d), ``specs`` to a tuple, which may
    be longer than the leaf's rank by leading prefix entries (a
    satellite dim); ``mesh`` is a ``DeviceMesh`` or ``{axis: size}``."""
    msize = mesh_sizes(mesh)[MODEL]

    def fix(x: Any, s: tuple) -> tuple:
        parts = list(s)
        shape = tuple(getattr(x, "shape", ()))
        offset = len(parts) - len(shape)
        for i, ax in enumerate(parts):
            if ax != "model" or i < offset:
                continue
            if shape[i - offset] % msize == 0:
                continue
            parts[i] = None
            for j in range(len(shape)):
                if (shape[j] % msize == 0 and shape[j] >= msize
                        and parts[offset + j] is None):
                    parts[offset + j] = "model"
                    break
        return tuple(parts)

    return {k: fix(example[k], s) for k, s in specs.items()}



# ---------------------------------------------------------------- shards
def shard_leaf(x: Any, spec: Optional[tuple], m: int, r: int,
               parts: int = 1, lead: int = 0) -> Any:
    """Rank ``r``'s contiguous shard of ``x`` (numpy or torch) by its
    trailing ``spec``, of ``m`` ranks; a replicated leaf comes back as
    it is."""
    d = model_dim(spec)
    if d is None:
        return x
    dim = lead + d
    n = x.shape[dim]
    if n % (parts * m):
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {parts} part(s) of {m} shards")
    step = n // (parts * m)
    pieces = [x[(slice(None),) * dim + (slice(a, a + step),)]
              for a in range(r * step, n, n // parts)]
    if isinstance(x, np.ndarray):
        return np.concatenate(pieces, axis=dim)
    return torch.cat(pieces, dim)       # a new, contiguous tensor


def unshard_leaf(pieces: list, spec: Optional[tuple], parts: int = 1,
                 lead: int = 0) -> Any:
    """The inverse of :func:`shard_leaf` over every rank's piece (in rank
    order): the full leaf."""
    d = model_dim(spec)
    if d is None:
        return pieces[0]
    dim = lead + d
    if isinstance(pieces[0], np.ndarray):
        split = [np.split(p, parts, axis=dim) for p in pieces]
        return np.concatenate([s[j] for j in range(parts) for s in split],
                              axis=dim)
    split = [torch.chunk(p, parts, dim=dim) for p in pieces]
    return torch.cat([s[j] for j in range(parts) for s in split], dim=dim)


def shard_params(full: Mapping[str, Any], specs: Mapping[str, tuple],
                 axis: "ModelAxis", lead: int = 0) -> dict:
    """``full``'s leaves (numpy or torch) as this rank's contiguous shards
    (:func:`shard_leaf`); ``specs`` are the sanitized trailing specs,
    ``lead`` leading dims precede them on every leaf."""
    return {k: shard_leaf(v, specs[k], axis.size, axis.rank,
                          fused_parts(k), lead)
            for k, v in full.items()}


def gather_params(local: Mapping[str, torch.Tensor],
                  specs: Mapping[str, tuple], axis: "ModelAxis",
                  lead: int = 0) -> dict:
    """Every rank's shards (torch) gathered over ``model`` into whole
    leaves, on every rank: the inverse of :func:`shard_params`. Called by
    every rank of the group. Returns new tensors (detached)."""
    out = {}
    for k, v in local.items():
        if model_dim(specs[k]) is None:
            out[k] = v.detach().clone()
            continue
        pieces = axis._gather_pieces(v.detach().contiguous())
        out[k] = unshard_leaf(pieces, specs[k], fused_parts(k), lead)
    return out


# ----------------------------------------------------------- collectives
class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce of the gradient over ``model``."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis._all_reduce(g.contiguous().clone()), None


class _Exit(torch.autograd.Function):
    """All-reduce forward over ``model``, identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return axis._all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` (of ``parts`` equal parts, as
    :func:`unshard_leaf`) forward; the rank's shard of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, axis, dim, parts):
        ctx.axis, ctx.dim, ctx.parts = axis, dim, parts
        return axis._gather_dim(x.contiguous(), dim, parts)

    @staticmethod
    def backward(ctx, g):
        return (shard_leaf(g, (None,) * ctx.dim + (MODEL,), ctx.axis.size,
                           ctx.axis.rank, ctx.parts), None, None, None)


class ModelAxis:
    """The ``model`` axis of a mesh as the layers see it: its process
    group, its size ``m``, this rank's index ``rank``, and per leaf key
    the sanitized trailing spec (``specs``); ``def_specs``, the specs the
    model's defs give (the layers' parallel forms), tell which leaves
    ``sanitize_specs`` relocated."""

    def __init__(self, group: Any, size: int, rank: int,
                 specs: Mapping[str, tuple],
                 def_specs: Mapping[str, tuple]):
        self.group, self.size, self.rank = group, int(size), int(rank)
        self.specs = dict(specs)
        #: Leaves sharded elsewhere than their parallel form wants: gathered
        #: once a forward (:meth:`prepare`).
        self.relocated = {k for k, s in self.specs.items()
                          if model_dim(s) is not None
                          and s != def_specs.get(k)}
        #: What the layers read: a relocated leaf counts as replicated.
        self.use_specs = {k: ((None,) * len(s) if k in self.relocated
                              else s) for k, s in self.specs.items()}
        #: Every leaf (key) a layer gathered at use.
        self.gathered: set[str] = set()

    @classmethod
    def from_mesh(cls, mesh: Any, specs: Mapping[str, tuple],
                  def_specs: Mapping[str, tuple]) -> "ModelAxis":
        """The ``model`` dim of ``mesh`` (a ``DeviceMesh``)."""
        names = list(mesh.mesh_dim_names)
        size = mesh.shape[names.index(MODEL)]
        return cls(mesh.get_group(MODEL), size, mesh.get_local_rank(MODEL),
                   specs, def_specs)

    # ---------------------------------------------------- raw collectives
    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        meter.report_collective("all-reduce", x.numel() * x.element_size())
        if x.device.type != "meta":
            dist.all_reduce(x, group=self.group)
        return x

    def _gather_pieces(self, x: torch.Tensor) -> list:
        """Every rank's ``x`` (same shape), in rank order."""
        meter.report_collective("all-gather",
                                self.size * x.numel() * x.element_size())
        if x.device.type == "meta":
            return [x.new_empty(x.shape) for _ in range(self.size)]
        flat = x.reshape(-1)
        out = flat.new_empty(self.size * flat.numel())
        with warnings.catch_warnings():
            # torch >= 2.12 renames it all_gather_single; the call is the
            # same.
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, flat, group=self.group)
        return list(out.view(self.size, *x.shape).unbind(0))

    def _gather_dim(self, x: torch.Tensor, dim: int,
                    parts: int) -> torch.Tensor:
        spec = (None,) * dim + (MODEL,)
        return unshard_leaf(self._gather_pieces(x), spec, parts)

    # ------------------------------------------------- autograd-aware ops
    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as it is; its gradient all-reduced over ``model``."""
        return _Enter.apply(x, self)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``; the gradient passes as it is."""
        return _Exit.apply(x, self)

    def gather(self, x: torch.Tensor, dim: int,
               parts: int = 1) -> torch.Tensor:
        """Every rank's ``x`` joined along ``dim`` (of ``parts`` parts);
        the gradient's own shard comes back."""
        return _Gather.apply(x, self, dim, parts)

    def local(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """A replicated leaf's own ``1/m`` of ``dim`` (e.g. RWKV's
        ``decay_base`` for the rank's channels), through :meth:`enter`:
        every rank's gradient covers its own slice, and the all-reduce
        sums them into the whole."""
        n = x.shape[dim] // self.size
        return self.enter(x).narrow(dim, self.rank * n, n)

    # ----------------------------------------------------------- params
    def prepare(self, params: Mapping[str, torch.Tensor]) -> dict:
        """``params`` with every relocated leaf gathered whole (once per
        forward); the others as they are. Prepared params come back as
        they are."""
        if isinstance(params, Prepared):
            return params
        out = Prepared(params)
        for k in params:            # in the same order on every rank
            if k in self.relocated:
                out[k] = self.gather(out[k], model_dim(self.specs[k]),
                                     fused_parts(k))
                self.gathered.add(k)
        return out

    def shards(self, prefix: str, layer: bool) -> "Shards":
        """The specs of the leaves under ``prefix``, nested as
        ``transformer._layer`` nests the params; ``layer``: the leaves are
        stacked over layers and a layer's view drops that first dim."""
        tree: dict = {}
        for key, spec in self.use_specs.items():
            if key.startswith(prefix):
                *path, name = key[len(prefix):].split("/")
                node = tree
                for part in path:
                    node = node.setdefault(part, {})
                node[name] = (key, spec[1:] if layer else spec)
        return Shards(self, tree)


class Prepared(dict):
    """Params whose relocated leaves :meth:`ModelAxis.prepare` gathered."""


class Shards:
    """One block's (or one sublayer's) leaves' specs, for the layer
    functions: ``tree`` maps each name to ``(key, spec)`` or to a nested
    dict for a sublayer."""

    def __init__(self, axis: ModelAxis, tree: dict):
        self.axis, self.tree = axis, tree

    @property
    def size(self) -> int:
        return self.axis.size

    @property
    def rank(self) -> int:
        return self.axis.rank

    def sub(self, name: str) -> "Shards":
        return Shards(self.axis, self.tree.get(name, {}))

    def dim(self, name: str) -> Optional[int]:
        entry = self.tree.get(name)
        return None if entry is None else model_dim(entry[1])

    def parallel(self, want: Mapping[str, int],
                 units: Optional[int] = None) -> bool:
        """Whether the layer can run on its shards: every leaf of ``want``
        (name -> the dim its parallel form shards) that the layer has is
        sharded there, and ``units`` (heads, channels, experts; None: no
        such unit) divide by ``m``."""
        present = [n for n in want if n in self.tree]
        return (bool(present)
                and (units is None or units % self.size == 0)
                and all(self.dim(n) == want[n] for n in present))

    def gather_leaf(self, p: Mapping[str, torch.Tensor],
                    name: str) -> torch.Tensor:
        """Leaf ``name`` of ``p`` whole: gathered if sharded."""
        d = self.dim(name)
        if d is None:
            return p[name]
        key = self.tree[name][0]
        self.axis.gathered.add(key)
        return self.axis.gather(p[name], d, fused_parts(key))

    def gather_all(self, p: Mapping[str, Any]) -> dict:
        """Every sharded tensor leaf at the top of ``p`` gathered whole."""
        return {k: (self.gather_leaf(p, k) if isinstance(v, torch.Tensor)
                    else v) for k, v in p.items()}

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return self.axis.enter(x)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return self.axis.exit(x)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return self.axis.gather(x, dim)

    def local(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return self.axis.local(x, dim)


def on_shards(tp: Optional[Shards], p: Mapping[str, Any],
              want: Mapping[str, int], units: Optional[int] = None):
    """``(p, tp)`` for a layer: as given where the layer runs on its
    shards (:meth:`Shards.parallel`); else ``p`` with its sharded leaves
    gathered and ``tp`` None, so the layer runs whole on every rank. With
    no ``tp`` (no ``model`` axis), ``(p, None)``."""
    if tp is None:
        return p, None
    if tp.parallel(want, units):
        return p, tp
    return tp.gather_all(p), None


__all__ = ["FUSED", "MODEL", "ModelAxis", "Prepared", "Shards",
           "fused_parts", "gather_params", "local_shape", "mesh_sizes",
           "model_dim", "on_shards", "sanitize_specs", "shard_leaf",
           "shard_params", "unshard_leaf"]
