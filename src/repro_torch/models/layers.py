"""Model primitives, the dense subset: the port of ``repro.models.layers``.

Every module is a pair ``init_*(generator, ...) -> params-dict`` and an
apply function, over the reference's parameter layout (weights ``(d_in,
d_out)``, applied as ``x @ w``), so that a reference param tree carries
across leaf for leaf (``models.carry``). The init functions take a
``lead`` shape that is prepended to every leaf: the transformer keeps
each slot's layers stacked in one tensor, as the reference does.

Numerics follow the reference's order: params in bf16 and norm scales
in f32; a norm computes in f32 and casts back; RoPE rotates in f32;
attention takes its logits, softmax and sums in f32.

Here so far: ``dense``, the norms, the activations, full, partial, 2d
and M-RoPE, dense attention (``_attend_dense``), flash attention with a
backward that recomputes the score blocks, the GQA attention block with
its decode cache (a ring buffer under a window) and as cross-attention
(whisper's decoder), the (gated) MLP, the causal depthwise conv1d, the
RG-LRU block (griffin) and the SSD block (mamba2), each with its decode
state, MLA (deepseek-v3's latent-compressed attention, absorbed at
decode) with its latent cache, and the mixture of experts (a router,
the reference's sort-based capacity dispatch, the batched experts and a
combine in a fixed order). Every decode state is written in place: the
attention and latent caches' slots, the recurrent ``h`` and the conv
tail, so a state's tensors keep their addresses across steps.

Partitioning: the model code is mesh-agnostic. ``launch.build.
partitioning`` binds the logical axes (``dp`` the batch, ``tp`` the
features, heads and experts) to a :class:`DeviceMesh`'s axes and hands
the model DTensors (params placed by ``launch.sharding``); unbound, or
on plain tensors, every hook below is a no-op. ``constrain`` is the
reference's ``with_sharding_constraint`` (``DTensor.redistribute``);
the ops DTensor has no sharded strategy for run on each rank's own
shard (``_local_call``: flash attention, the slot writes, the scans)
as GSPMD runs them; the MoE block takes the reference's
expert-parallel ``_moe_sharded``, explicit local tensors and a
``Fabric`` all-to-all over the model axis.
"""
from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.utils.partitioning import (AXES, contiguous_stride,
                                            placements_of)
from repro_torch.utils.trees import is_dtensor

# ----------------------------------------------------------------------
# logical partitioning (activation sharding constraints)
# ----------------------------------------------------------------------
# The launcher binds logical axes ("dp" for batch, "tp" for tensor /
# feature / expert parallel) to mesh axis names before it runs the
# model (``utils.partitioning.AXES``). Unbound (the unpartitioned paths)
# -> the hooks are no-ops.

# which MoE path ran, by name: {"global": n, "sharded": n}
MOE_PATHS: dict = {"global": 0, "sharded": 0}


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor




def _dp_axes() -> tuple:
    dp = AXES["dp"] or ()
    return dp if isinstance(dp, tuple) else (dp,)


def logical_spec(shape, logical) -> tuple:
    """The mesh spec of logical dims ('dp' | 'tp' | 'dpt' | None) for a
    tensor of ``shape``, the reference's rule: 'dpt' is the data and
    model axes together (context parallelism), and an axis is dropped
    from a dim of size 1 or one under 16 that is not a multiple of 8
    (the B=1 long-context batch, whisper's 6 heads)."""
    parts = []
    for i, lg in enumerate(logical):
        if lg == "dpt":
            ax = tuple(a for a in (*_dp_axes(), AXES["tp"]) if a) or None
        elif lg == "dp":
            ax = _dp_axes() or None
        else:
            ax = AXES.get(lg) if isinstance(lg, str) else None
        if ax is not None and (shape[i] == 1
                               or (shape[i] < 16 and shape[i] % 8 != 0)):
            ax = None
        parts.append(ax)
    return tuple(parts) + (None,) * (len(shape) - len(parts))


def replicated(x):
    """A DTensor made whole on every rank (partial sums reduced, shards
    gathered); anything else as it is. A loss must be: the gradient a
    backward seeds is a ones of the loss's placements, and a partial
    ones sums to the rank count."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def constrain(x, *logical):
    """``with_sharding_constraint`` by logical dims: a DTensor is
    redistributed to the placements they give; anything else comes back
    as it is."""
    if not is_dtensor(x) or (AXES["dp"] is None and AXES["tp"] is None):
        return x
    pl = placements_of(logical_spec(x.shape, logical), x.device_mesh)
    return x if tuple(x.placements) == pl else x.redistribute(
        x.device_mesh, pl)


def _as_dt(x, mesh):
    """A plain tensor as a DTensor replicated on ``mesh`` (every rank
    holds the same value: positions, index tables)."""
    if is_dtensor(x) or not isinstance(x, torch.Tensor):
        return x
    from torch.distributed.tensor import Replicate
    return _dtensor().from_local(x, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)


def _split_axes(specs, mesh) -> set:
    """The mesh axes any of ``specs`` splits a dim over."""
    out = set()
    for spec in specs:
        for e in spec:
            out |= set((e,) if isinstance(e, str) else e or ())
    return out


def _flatten(t, shape):
    """``t.reshape(shape)``, ``shape`` merging t's last dims into one. A
    DTensor whose first merged dim is split unevenly over its axes (40
    heads over 16) is first gathered on it: DTensor cannot merge an
    uneven split, where GSPMD pads it."""
    if is_dtensor(t):
        k = len(shape) - 1
        e = _spec_of(t)[k]
        if e is not None and t.shape[k] % _axes_size(e, t.device_mesh):
            spec = tuple(None if i == k else x
                         for i, x in enumerate(_spec_of(t)))
            t = t.redistribute(t.device_mesh,
                               placements_of(spec, t.device_mesh))
    return t.reshape(shape)


def _local_of(t, spec, mesh, partial_grad=()):
    """This rank's shard of ``t`` (a plain tensor taken as replicated)
    under ``spec``. ``partial_grad``: the mesh axes over which this
    rank's use of the shard differs from its peers' (the computation is
    split there), so that the shard's gradient is a partial sum over
    them (summed when it reaches ``t``); elsewhere a replicated shard's
    gradient is whole on every rank, as its use is."""
    from torch.distributed.tensor import Partial, Replicate
    t = _as_dt(t, mesh)
    pl = placements_of(spec, mesh)
    if tuple(t.placements) != pl:
        t = t.redistribute(mesh, pl)
    names = mesh.mesh_dim_names
    grad = [Partial() if isinstance(p, Replicate) and names[i] in
            partial_grad else p for i, p in enumerate(pl)]
    return t.to_local(grad_placements=grad)


def _local_call(fn, ins, outs):
    """Run ``fn`` on each rank's own shards: ``ins`` are (tensor, spec)
    pairs, each redistributed to its spec's placements (a plain tensor
    first taken as replicated) and passed as its local shard; ``fn``
    returns local tensors, one for each (spec, global shape) of
    ``outs``, wrapped back as DTensors with that global shape (the
    shards may be uneven). Differentiable both ways: over the axes the
    outputs are split over, the computation is split, and an input
    replicated there has a partial gradient on each rank."""
    DT = _dtensor()
    mesh = next(t.device_mesh for t, _ in ins if is_dtensor(t))
    split = _split_axes([spec for spec, _ in outs], mesh)
    local = [t if spec is None else _local_of(t, spec, mesh, split)
             for t, spec in ins]
    res = fn(*local)
    single = not isinstance(res, tuple)
    res = (res,) if single else res
    # contiguous, as the strides the DTensor declares
    wrapped = tuple(DT.from_local(r.contiguous(), mesh,
                                  placements_of(spec, mesh),
                                  run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))
                    for r, (spec, shape) in zip(res, outs))
    return wrapped[0] if single else wrapped


def _axes_size(entry, mesh) -> int:
    """The devices a spec entry's axes span (1 for None)."""
    names = list(mesh.mesh_dim_names)
    return math.prod(int(mesh.size(names.index(a))) for a in
                     ((entry,) if isinstance(entry, str) else entry or ()))


def _shard_offset(n: int, spec_entry, mesh) -> int:
    """The first index of this rank's shard of a dim of size ``n`` split
    over ``spec_entry``'s axes (torch.chunk's rule, in mesh order)."""
    if spec_entry is None:
        return 0
    names = list(mesh.mesh_dim_names)
    axes = (spec_entry,) if isinstance(spec_entry, str) else spec_entry
    coord = mesh.get_coordinate()
    off, size = 0, n
    for a in sorted(axes, key=names.index):
        k = int(mesh.size(names.index(a)))
        full = -(size // -k)
        i = coord[names.index(a)]
        off += min(i * full, size)
        size = max(0, min(full, size - i * full))
    return off


# ----------------------------------------------------------------------
# basics
# ----------------------------------------------------------------------


def _randn(gen: torch.Generator | None, shape) -> torch.Tensor:
    """Standard normal f32 from ``gen`` on its device; with no generator,
    PyTorch's default one on the default device (under
    ``torch.device("meta")``: shapes only, nothing allocated)."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=None if gen is None else gen.device)


def _device(gen: torch.Generator | None):
    return None if gen is None else gen.device


# a leaf whose f32 draw takes at most this many bytes is drawn whole
_WHOLE_DRAW_BYTES = 1 << 31


def _normal(gen, shape, scale, dtype, lead=()) -> torch.Tensor:
    """``scale`` times a standard normal draw of ``(*lead, *shape)`` in
    ``dtype``. A leaf whose f32 draw exceeds ``_WHOLE_DRAW_BYTES`` is
    drawn one slot of ``lead`` at a time, so that the f32 transient is
    one slot's (command-r-35b's stacked (40, 8192, 22528) ``w_gate`` is
    29.5 GB in f32, a slot 0.74 GB); a slot that still exceeds it one
    row of its first axis at a time (an expert: llama4-maverick's slot
    of ``w_up``, (128, 5120, 8192), is 21.5 GB in f32, an expert 0.17
    GB); a smaller one whole, as it always was. On the CPU generator
    these give the same values wherever a part holds a multiple of 16
    elements; on the CUDA one they do not, so the whole draw keeps the
    smaller configs' random models (tinyllama-1.1b's among them) as they
    were."""
    if 4 * math.prod(lead) * math.prod(shape) <= _WHOLE_DRAW_BYTES:
        return _randn(gen, (*lead, *shape)).mul_(scale).to(dtype)
    out = torch.empty((*lead, *shape), dtype=dtype, device=_device(gen))
    if out.is_meta:                 # shapes only: nothing to draw
        return out
    if 4 * math.prod(shape) > _WHOLE_DRAW_BYTES and len(shape) > 1:
        lead, shape = (*lead, shape[0]), shape[1:]
    for idx in itertools.product(*map(range, lead)):
        out[idx] = _randn(gen, shape).mul_(scale)
    return out


def _uniform(gen, shape, lo, hi) -> torch.Tensor:
    """Uniform f32 on [lo, hi) from ``gen`` on its device."""
    return torch.empty(shape, dtype=torch.float32,
                       device=_device(gen)).uniform_(lo, hi, generator=gen)


def dense_init(gen, d_in, d_out, *, bias=False, dtype=torch.bfloat16,
               scale=None, lead=()):
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype, lead)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype,
                             device=_device(gen))
    return p


def _tp_axes(mesh) -> tuple:
    return (AXES["tp"],) if AXES["tp"] else tuple(
        n for n in mesh.mesh_dim_names if n not in ("pod", "data"))


def embed_lookup(table, tokens):
    """``table[tokens]``, the token embedding. On DTensors each rank
    gathers its rows of tokens (over dp) from its shard of the table,
    the table gathered over the data axes first (fsdp): the untied
    table's feature columns over tp need no collective (the reference's
    reason for that spec); the tied one's vocab rows over tp give each
    rank the ids in its slice (zeros elsewhere), summed over tp by the
    next ``constrain`` (Megatron's vocab-parallel embedding)."""
    if not is_dtensor(table):
        return table[tokens.long()]
    mesh = table.device_mesh
    tp = _tp_axes(mesh)
    t_spec = tuple(_only(e, tp) for e in _spec_of(table))
    tok_spec = logical_spec(tokens.shape, ("dp", None))
    V, d = table.shape
    shape = (*tokens.shape, d)
    if t_spec[0] is None:
        return _local_call(lambda t, ids: t[ids.long()],
                           [(table, t_spec), (tokens, tok_spec)],
                           [((tok_spec[0], None, t_spec[1]), shape)])
    v0 = _shard_offset(V, t_spec[0], mesh)
    tl = _local_of(table, t_spec, mesh, set(mesh.mesh_dim_names))
    il = _local_of(tokens, tok_spec, mesh).long()
    inside = (il >= v0) & (il < v0 + tl.shape[0])
    rows = tl[(il - v0).clamp(0, max(tl.shape[0] - 1, 0))]
    part = torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return _partial(part, mesh, (tok_spec[0], None, None), t_spec[0], shape,
                    "sum")


def _vocab_parts(logits):
    """(mesh, logits' spec, the tp axes splitting its last dim, this
    rank's offset into it)."""
    mesh = logits.device_mesh
    spec = _spec_of(logits)
    return mesh, spec, spec[-1], _shard_offset(logits.shape[-1], spec[-1],
                                               mesh)


def _partial(t, mesh, spec, axes, shape, op):
    """``t`` (this rank's part) as a DTensor placed by ``spec``, pending
    a ``op`` reduction over ``axes``."""
    from torch.distributed.tensor import Partial
    pl = list(placements_of(spec, mesh))
    for a in (axes,) if isinstance(axes, str) else axes:
        pl[mesh.mesh_dim_names.index(a)] = Partial(op)
    return _dtensor().from_local(t, mesh, pl, run_check=False,
                                 shape=torch.Size(shape),
                                 stride=contiguous_stride(shape))


def vocab_gather(logits, idx):
    """``logits.gather(-1, idx[..., None])[..., 0]``; on DTensor logits
    whose vocab dim is split, each rank picks the ids in its slice (zero
    elsewhere) and the parts are summed over those axes (the
    vocab-parallel cross-entropy's gather)."""
    if not is_dtensor(logits) or _spec_of(logits)[-1] is None:
        return torch.gather(logits, -1, idx[..., None])[..., 0]
    mesh, spec, ax, v0 = _vocab_parts(logits)
    row = spec[:-1]
    ll, il = logits.to_local(), _local_of(idx, row, mesh)
    inside = (il >= v0) & (il < v0 + ll.shape[-1])
    lid = (il - v0).clamp(0, max(ll.shape[-1] - 1, 0))
    part = torch.where(inside, ll.gather(-1, lid[..., None])[..., 0],
                       torch.zeros((), dtype=ll.dtype, device=ll.device))
    return _partial(part, mesh, row, ax, idx.shape, "sum")


def vocab_logsumexp(logits):
    """``torch.logsumexp(logits, -1)``; on a vocab dim split over more
    than one device, each rank's slice's exponent sum about the global
    max (a max reduction, held constant for the gradient, as the
    logsumexp is invariant to it), summed over the axes: two numbers a
    row move, not the logits (DTensor's own logsumexp gathers them)."""
    if not is_dtensor(logits) or _spec_of(logits)[-1] is None:
        return torch.logsumexp(logits, dim=-1)
    mesh, spec, ax, _ = _vocab_parts(logits)
    row, shape = spec[:-1], logits.shape[:-1]
    row_pl = placements_of(row, mesh)
    if _axes_size(ax, mesh) == 1:       # nothing to reduce: the plain op
        return _dtensor().from_local(
            torch.logsumexp(_local_of(logits, spec, mesh), dim=-1), mesh,
            row_pl, run_check=False, shape=shape,
            stride=contiguous_stride(shape))
    ll = logits.to_local()
    m = _partial(ll.detach().amax(-1), mesh, row, ax, shape,
                 "max").redistribute(mesh, row_pl)
    part = torch.exp(ll - m.to_local()[..., None]).sum(-1)
    total = _partial(part, mesh, row, ax, shape, "sum").redistribute(
        mesh, row_pl)
    return torch.log(total) + m


def vocab_argmax(logits):
    """``logits.argmax(-1)`` (the first maximum); on a split vocab dim,
    each slice's first maximum, the largest value over the axes (a max
    reduction), then the smallest global index holding it (a min
    reduction): two numbers a row, not the gathered logits."""
    if not is_dtensor(logits) or _spec_of(logits)[-1] is None:
        return logits.argmax(-1)
    mesh, spec, ax, v0 = _vocab_parts(logits)
    row, shape = spec[:-1], logits.shape[:-1]
    ll = logits.to_local()
    lmax, lidx = ll.max(-1)                 # the slice's first maximum
    gmax = _partial(lmax, mesh, row, ax, shape, "max").redistribute(
        mesh, placements_of(row, mesh)).to_local()
    idx = torch.where(lmax == gmax, lidx + v0,
                      torch.full_like(lidx, logits.shape[-1]))
    return _partial(idx, mesh, row, ax, shape, "min")


def dense(p, x):
    """``x @ w (+ b)``, in the promoted dtype where x's and w's differ, as
    jnp's product promotes (whisper's bf16 frames into f32 weights)."""
    w = p["w"]
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = _matmul_sharded(x, w) if is_dtensor(w) or is_dtensor(x) else x @ w
    if "b" in p:
        y = y + p["b"]
    return y


def _only(entry, axes) -> object:
    """A spec entry kept to the mesh axes in ``axes``."""
    if entry is None:
        return None
    kept = tuple(a for a in ((entry,) if isinstance(entry, str) else entry)
                 if a in axes)
    return None if not kept else kept[0] if len(kept) == 1 else kept


def _matmul_sharded(x, w):
    """``x @ w`` (x (..., d_in), w (d_in, d_out)) on each rank's shards,
    as GSPMD partitions it: the weight gathered over the data axes
    (fsdp), its tp split kept: column-parallel (d_out over tp) takes x
    whole over tp, its rows over dp; row-parallel (d_in over tp) takes
    x's features split the same way and leaves a partial sum over tp
    (``Partial``), which the next ``constrain`` reduces; a weight
    replicated over tp keeps x's split of its middle dims."""
    from torch.distributed.tensor import Partial
    mesh = (w if is_dtensor(w) else x).device_mesh
    tp = _tp_axes(mesh)
    dp = tuple(n for n in mesh.mesh_dim_names if n not in tp)
    w_spec = tuple(_only(e, tp) for e in (_spec_of(w) if is_dtensor(w)
                                          else (None, None)))
    x_cur = _spec_of(x) if is_dtensor(x) else (None,) * x.ndim
    mids = (tuple(_only(e, tp) for e in x_cur[1:-1]) if w_spec == (None, None)
            else (None,) * (x.ndim - 2))
    x_spec = ((_only(x_cur[0], dp),) + mids + (w_spec[0],)
              if x.ndim >= 2 else (w_spec[0],))
    y_spec = x_spec[:-1] + (w_spec[1],)
    shape = (*x.shape[:-1], w.shape[1])
    if w_spec[0] is None:
        return _local_call(torch.matmul, [(x, x_spec), (w, w_spec)],
                           [(y_spec, shape)])
    split = _split_axes([y_spec], mesh) | set(
        (w_spec[0],) if isinstance(w_spec[0], str) else w_spec[0])
    xl = _local_of(x, x_spec, mesh, split)
    wl = _local_of(w, w_spec, mesh, split)
    pl = list(placements_of(y_spec, mesh))
    for a in (w_spec[0],) if isinstance(w_spec[0], str) else w_spec[0]:
        pl[mesh.mesh_dim_names.index(a)] = Partial()
    return _dtensor().from_local(xl @ wl, mesh, pl, run_check=False,
                                 shape=torch.Size(shape),
                                 stride=contiguous_stride(shape))


def norm_init(d, kind="rmsnorm", *, lead=(), device=None):
    p = {"scale": torch.ones((*lead, d), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((*lead, d), dtype=torch.float32,
                                device=device)
    return p


def apply_norm(p, x, kind="rmsnorm", eps=1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    else:
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, -1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if "bias" in p:
            y = y + p["bias"]
    return (y * p["scale"]).to(x.dtype)


class _Logistic(torch.autograd.Function):
    """``jax.nn.sigmoid`` (``lax.logistic``): ``1 / (1 + exp(-x))``, each
    op rounded in x's dtype, which is how the reference computes it in
    bf16 (``torch.sigmoid`` rounds once and differs at a third of the
    bf16 elements); its derivative ``s * (1 - s)`` from the output, as
    jax's, so that ``exp(-x) = inf`` gives 0 and not NaN. Four kernels
    where ``torch.sigmoid`` is one: the SSD block takes it, the MLP's
    silu keeps ``torch.sigmoid`` (see ``_ACTS``)."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def _sigmoid(x):
    """``jax.nn.sigmoid``: op by op (``_Logistic``) below f32; in f32
    ``torch.sigmoid``, within an ulp of it."""
    return torch.sigmoid(x) if x.dtype == torch.float32 else (
        _Logistic.apply(x))


def _rounded(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``: jax rounds a Python scalar to the
    array's dtype before the op, PyTorch keeps it at full precision."""
    f = np.float32(v)               # torch rounds a double via float too
    if dtype == torch.bfloat16:     # round to nearest even, 16 bits
        b = int(f.view(np.uint32))
        b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
        return float(np.uint32(b).view(np.float32))
    if dtype == torch.float16:
        return float(np.float16(f))
    return float(f) if dtype == torch.float32 else float(v)


def _gelu(x):
    """``jax.nn.gelu`` (``approximate=True``), op by op in x's dtype with
    its constants rounded to it; ``F.gelu(approximate="tanh")`` rounds
    once and misses recurrentgemma's bf16 logits at 1.9-2.0x the
    elements the reference's own op-by-op run does."""
    c = _rounded(math.sqrt(2 / math.pi), x.dtype)
    k = _rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x ** 3)))))


_ACTS = {
    # the reference's jax.nn.silu, x * sigmoid(x): in bf16 the sigmoid is
    # rounded before the product (F.silu rounds once, and misses the
    # reference's bf16 logits at twice as many elements). The dense MLPs
    # meet the reference's bf16 logits with torch.sigmoid; _sigmoid's
    # op-by-op form slowed tinyllama's train step by ~5% (PERF.md)
    "silu": lambda x: x * torch.sigmoid(x),
    "gelu": _gelu,
    "relu2": lambda x: torch.square(F.relu(x)),
}


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (F.softplus
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))

# ----------------------------------------------------------------------
# RoPE (full / partial / 2d / M-RoPE)
# ----------------------------------------------------------------------


def _rope_angles(positions, rot_dim, theta):
    """positions (..., S) -> cos/sin of shape (..., S, rot_dim/2)."""
    ar = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                      device=positions.device)
    inv = 1.0 / (theta ** (ar / rot_dim))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """x (..., rot_dim) with cos/sin (..., rot_dim/2): pairwise rotation."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _mrope_angles(positions, rot_dim, theta):
    """M-RoPE: positions (B, S, 3), the (t, h, w) components, each
    rotating its own section of the rot_dim/2 pairs: ``[half - 2 *
    (half // 3), half // 3, half // 3]`` (22 / 21 / 21 at head_dim 128,
    the reference's split, not Qwen2-VL's published 16 / 24 / 24). The
    angles of all three components come from one ``_rope_angles`` call
    and each pair takes its component's: the reference's three calls
    and concatenation, in fewer kernels."""
    half = rot_dim // 2
    b1, b2 = half - 2 * (half // 3), half - half // 3
    cos, sin = _rope_angles(positions, rot_dim, theta)   # (B, S, 3, half)
    j = torch.arange(half, device=positions.device)
    comp = ((j >= b1).long() + (j >= b2).long()).expand(
        *cos.shape[:-2], 1, half)
    return cos.gather(-2, comp)[..., 0, :], sin.gather(-2, comp)[..., 0, :]


def apply_rope(x, positions, cfg: ModelConfig):
    """x (B,S,H,D); positions (B,S), or (B,S,3) under ``"mrope"`` (a (B,
    S) one then stands for all three components). ``"2d"`` rotates the
    first half of the head dims, ``"partial"`` its ``rope_frac``."""
    D = x.shape[-1]
    if cfg.rope_style == "none":
        return x
    rot = int(D * (0.5 if cfg.rope_style == "2d" else cfg.rope_frac))
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    if cfg.rope_style == "mrope":
        if positions.ndim == 2:
            positions = positions[..., None].expand(*positions.shape, 3)
        cos, sin = _mrope_angles(positions, rot, cfg.rope_theta)
    else:
        cos, sin = _rope_angles(positions, rot, cfg.rope_theta)
    out = _rotate(xr.float(), cos[:, :, None, :], sin[:, :, None, :])
    return torch.cat([out.to(x.dtype), xp], -1)

# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------


def _reduced(t, mesh, spec, axes, op):
    """This rank's part ``t`` reduced by ``op`` over ``axes`` (an
    all-reduce), placed by ``spec`` over the other axes."""
    full = _partial(t, mesh, spec, axes, tuple(t.shape), op)
    return full.redistribute(mesh, placements_of(spec, mesh)).to_local()


def _attend_dense_sharded(q, k, v, mask, scale, softcap):
    """:func:`_attend_dense` on DTensors: each rank takes its rows (the
    keys' batch split) with every head. Keys and values split on their
    sequence (a context-parallel cache) attend as flash-decoding does:
    each rank's slots give a local max, exponent sum and weighted sum of
    values, reduced over the sequence's axes (max, then two sums) before
    the one division; unsplit, the plain function runs on the shard."""
    B, Sq, H, _ = q.shape
    Dv = v.shape[-1]
    mesh = (k if is_dtensor(k) else q).device_mesh
    ks = _spec_of(k) if is_dtensor(k) else (None,) * 4
    b, t = ks[0], ks[1]
    kv_spec = (b, t, None, None)
    ql = _local_of(q, (b, None, None, None), mesh)
    kl, vl = _local_of(k, kv_spec, mesh), _local_of(v, kv_spec, mesh)
    ml = None if mask is None else _local_of(
        mask.expand(B, *mask.shape[1:]), (b, None, None, t), mesh)
    out_spec = (b, None, None, None)
    if _axes_size(t, mesh) == 1:
        # nothing to reduce over: the plain function, its bits
        out = _attend_dense(ql, kl, vl, ml, scale, softcap)
    else:
        bl, KV, D = ql.shape[0], kl.shape[2], ql.shape[3]
        g = H // KV
        qf = (ql * scale).float().reshape(bl, Sq, KV, g, D)
        logits = torch.einsum("bqkgd,bskd->bkgqs", qf, kl.float())
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        if ml is not None:
            logits = torch.where(ml[:, :, None, :, :], logits,
                                 torch.full_like(logits, -1e30))
        m = _reduced(logits.amax(-1, keepdim=True), mesh,
                     (b, None, None, None, None), t, "max")
        e = torch.exp(logits - m)
        den = _reduced(e.sum(-1, keepdim=True), mesh,
                       (b, None, None, None, None), t, "sum")
        num = _reduced(torch.einsum("bkgqs,bskd->bkgqd", e, vl.float()),
                       mesh, (b, None, None, None, None), t, "sum")
        out = (num / den).permute(0, 3, 1, 2, 4).reshape(
            bl, Sq, H, Dv).to(ql.dtype)
    return _dtensor().from_local(
        out.contiguous(), mesh, placements_of(out_spec, mesh), run_check=False,
        shape=torch.Size((B, Sq, H, Dv)),
        stride=contiguous_stride((B, Sq, H, Dv)))


def _attend_dense(q, k, v, mask, scale, softcap=None):
    """Dense attention for short S. q (B,Sq,H,D), k/v (B,Skv,KV,D); mask
    broadcastable to (B,1,Sq,Skv) or None."""
    if is_dtensor(q) or is_dtensor(k):
        return _attend_dense_sharded(q, k, v, mask, scale, softcap)
    B, Sq, H, D = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    g = H // KV
    qf = (q * scale).float().reshape(B, Sq, KV, g, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if mask is not None:
        logits = torch.where(mask[:, :, None, :, :], logits,
                             torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def _chunk_mask(qpi, kpj, causal, window):
    """(B,1,1,qc,kvc) validity mask from absolute positions."""
    m = torch.ones((qpi.shape[0], 1, 1, qpi.shape[1], kpj.shape[1]),
                   dtype=torch.bool, device=qpi.device)
    if causal:
        m = m & (kpj[:, None, None, None, :] <= qpi[:, None, None, :, None])
    if window is not None:
        m = m & (kpj[:, None, None, None, :] >
                 qpi[:, None, None, :, None] - window)
    return m


def _spans(n: int, chunk: int):
    return [(s, min(s + chunk, n)) for s in range(0, n, chunk)]


class _Flash(torch.autograd.Function):
    """Streaming-softmax attention over q chunks and kv chunks, in f32.
    The forward keeps only the output and the row log-sum-exp; the
    backward recomputes each (q chunk x kv chunk) score block from them
    instead of saving S^2 probabilities (the reference's custom VJP,
    ``_flash_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, scale,
                q_chunk, kv_chunk, softcap):
        B, Sq, H, D = q.shape
        Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
        g = H // KV
        qf = q.float().reshape(B, Sq, KV, g, D)
        kf, vf = k.float(), v.float()
        outs = torch.empty((B, KV, g, Sq, Dv), dtype=torch.float32,
                           device=q.device)
        lses = torch.empty((B, KV, g, Sq), dtype=torch.float32,
                           device=q.device)
        for s0, s1 in _spans(Sq, q_chunk):
            qi, qpi = qf[:, s0:s1], q_pos[:, s0:s1]
            m = torch.full((B, KV, g, s1 - s0), -math.inf,
                           dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((B, KV, g, s1 - s0, Dv), dtype=torch.float32,
                              device=q.device)
            for a, b in _spans(Skv, kv_chunk):
                z = scale * torch.einsum("bqkgd,bskd->bkgqs", qi, kf[:, a:b])
                if softcap:
                    z = torch.tanh(z / softcap) * softcap
                z = torch.where(_chunk_mask(qpi, kv_pos[:, a:b], causal,
                                            window), z,
                                torch.full_like(z, -1e30))
                m_new = torch.maximum(m, z.amax(-1))
                p = torch.exp(z - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "bkgqs,bskd->bkgqd", p, vf[:, a:b])
                m = m_new
            outs[..., s0:s1, :] = acc / torch.clamp(l, min=1e-30)[..., None]
            lses[..., s0:s1] = torch.where(
                l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                torch.full_like(l, 1e30))
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, outs, lses)
        ctx.cfg = (causal, window, scale, q_chunk, kv_chunk, softcap)
        out = outs.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, outs, lses = ctx.saved_tensors
        causal, window, scale, q_chunk, kv_chunk, softcap = ctx.cfg
        B, Sq, H, D = q.shape
        Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
        g = H // KV
        qf = q.float().reshape(B, Sq, KV, g, D)
        kf, vf = k.float(), v.float()
        douts = dout.float().reshape(B, Sq, KV, g, Dv).permute(0, 2, 3, 1, 4)
        Dres = torch.sum(douts * outs, -1)                  # (B,KV,g,Sq)
        dq = torch.zeros((B, Sq, KV, g, D), dtype=torch.float32,
                         device=q.device)
        dk = torch.zeros((B, Skv, KV, D), dtype=torch.float32,
                         device=q.device)
        dv = torch.zeros((B, Skv, KV, Dv), dtype=torch.float32,
                         device=q.device)
        for s0, s1 in _spans(Sq, q_chunk):
            qi, qpi = qf[:, s0:s1], q_pos[:, s0:s1]
            lse_i, dout_i = lses[..., s0:s1], douts[..., s0:s1, :]
            D_i = Dres[..., s0:s1]
            dq_i = torch.zeros_like(qi)
            for a, b in _spans(Skv, kv_chunk):
                kj, vj = kf[:, a:b], vf[:, a:b]
                mask = _chunk_mask(qpi, kv_pos[:, a:b], causal, window)
                z = scale * torch.einsum("bqkgd,bskd->bkgqs", qi, kj)
                if softcap:
                    t = torch.tanh(z / softcap)
                    zc = torch.where(mask, t * softcap,
                                     torch.full_like(z, -1e30))
                else:
                    zc = torch.where(mask, z, torch.full_like(z, -1e30))
                p = torch.exp(zc - lse_i[..., None])
                dv_j = torch.einsum("bkgqs,bkgqd->bskd", p, dout_i)
                dp = torch.einsum("bkgqd,bskd->bkgqs", dout_i, vj)
                ds = p * (dp - D_i[..., None])
                if softcap:
                    ds = ds * (1.0 - t * t)
                dq_i = dq_i + scale * torch.einsum("bkgqs,bskd->bqkgd", ds,
                                                   kj)
                dk[:, a:b] += scale * torch.einsum("bkgqs,bqkgd->bskd", ds,
                                                   qi)
                dv[:, a:b] += dv_j
            dq[:, s0:s1] = dq_i
        return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype)) + (None,) * 8


def flash_attention(q, k, v, *, q_pos, kv_pos, causal=True, window=None,
                    scale, q_chunk=512, kv_chunk=1024, softcap=None):
    """Memory-efficient attention: O(S) residuals in both directions.
    q (B,Sq,H,D); k/v (B,Skv,KV,D) with GQA; q_pos (B,Sq), kv_pos (B,Skv)
    absolute positions for the causal and window masks. Returns
    (B,Sq,H,Dv) in q's dtype. On DTensors each rank attends over its own
    rows and heads (:func:`_attention_sharded`)."""
    def attend(q, k, v, q_pos, kv_pos):
        return _Flash.apply(q, k, v, q_pos, kv_pos, causal, window,
                            float(scale), int(min(q_chunk, q.shape[1])),
                            int(min(kv_chunk, k.shape[1])),
                            None if softcap is None else float(softcap))
    if is_dtensor(q) or is_dtensor(k):
        return _attention_sharded(attend, q, k, v, q_pos, kv_pos)
    return attend(q, k, v, q_pos, kv_pos)


def _attention_sharded(attend, q, k, v, q_pos, kv_pos):
    """``attend`` on each rank's shard: its rows of the batch (over dp)
    and its query heads (over tp, where the reference shards them), the
    keys and values replicated over tp (Megatron GQA); a rank whose
    heads are not all of them takes its heads' key/value heads
    (``h // (H / KV)``). What GSPMD runs for the reference's
    constraints, with no collective inside."""
    B, Sq, H, _ = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    q_spec = logical_spec(q.shape, ("dp", None, "tp", None))
    kv_spec = (q_spec[0], None, None, None)
    p_spec = (q_spec[0], None)
    mesh = (q if is_dtensor(q) else k).device_mesh

    def local(ql, kl, vl, qp, kp):
        Hl = ql.shape[2]
        if Hl != H:
            h0 = _shard_offset(H, q_spec[2], mesh)
            idx = (h0 + torch.arange(Hl, device=ql.device)) // (H // KV)
            kl, vl = kl[:, :, idx], vl[:, :, idx]
        # contiguous: DTensor reshapes by views of the local shard
        return attend(ql, kl, vl, qp, kp).contiguous()
    return _local_call(local, [(q, q_spec), (k, kv_spec), (v, kv_spec),
                               (q_pos, p_spec), (kv_pos, p_spec)],
                       [(q_spec, (B, Sq, H, Dv))])

# ----------------------------------------------------------------------
# GQA attention block over a whole sequence
# ----------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, dtype=torch.bfloat16, lead=()):
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, H * Dh, bias=cfg.attn_bias, dtype=dtype,
                         lead=lead),
        "wk": dense_init(gen, d, KV * Dh, bias=cfg.attn_bias, dtype=dtype,
                         lead=lead),
        "wv": dense_init(gen, d, KV * Dh, bias=cfg.attn_bias, dtype=dtype,
                         lead=lead),
        "wo": dense_init(gen, H * Dh, d, dtype=dtype, lead=lead),
    }


def attention_apply(p, cfg: ModelConfig, x, positions, *, mode="full",
                    state=None, local: bool = False, cross_kv=None):
    """GQA attention; returns (y, new_state). local=True uses
    cfg.rglru.local_window (hybrid) or cfg.sliding_window. positions:
    (B, S), or (B, S, 3) under M-RoPE, whose first component (``pos1d``)
    places the tokens for the masks and the cache.

    ``mode="full"``: flash attention over the whole sequence; with a
    ``state`` (prefill), the sequence's last T keys and values are also
    written into it. ``mode="step"`` (S == 1, decode): the token's key
    and value are written at ``pos % T`` and it attends densely over the
    whole cache, to the slots holding positions ``<= pos`` (and ``> pos
    - window`` when windowed). Either writes the cache in place, into
    the tensors of ``state``, and returns that same dict: a caller who
    kept an older ``state`` sees it change.

    ``cross_kv=(k, v, kv_pos)``: cross-attention (whisper's decoder) over
    given keys and values: no RoPE on them, no cache written, dense
    attention with no mask in both modes; ``state`` comes back as
    given."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = None
    if local:
        window = cfg.rglru.local_window if cfg.rglru else cfg.sliding_window
    scale = Dh ** -0.5
    if mode not in ("full", "step"):
        raise ValueError(f"attention_apply: mode {mode!r}, not 'full' or "
                         f"'step'")
    q = constrain(_unflatten(dense(p["wq"], x), (B, S, H, Dh)),
                  "dp", None, "tp", None)
    if cross_kv is not None:
        k, v, _ = cross_kv
        out = _attend_dense(q, k, v, None, scale, cfg.logit_softcap)
        return dense(p["wo"], constrain(_flatten(out, (B, S, H * Dh)),
                                        "dp", None, "tp")), state
    # GQA with few kv heads: kv is replicated over tp (Megatron GQA)
    k = constrain(_unflatten(dense(p["wk"], x), (B, S, KV, Dh)),
                  "dp", None, None, None)
    v = constrain(_unflatten(dense(p["wv"], x), (B, S, KV, Dh)),
                  "dp", None, None, None)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    pos1d = positions[..., 0] if positions.ndim == 3 else positions
    if mode == "full":
        out = flash_attention(q, k, v, q_pos=pos1d, kv_pos=pos1d,
                              causal=True, window=window, scale=scale,
                              softcap=cfg.logit_softcap)
        if state is not None:
            state = _slots_fill(state, {"k": k, "v": v}, pos1d)
    else:
        state = _slots_append(state, {"k": k, "v": v}, pos1d)
        cpos = state["pos_abs"]
        # logical_and, not &: DTensor's ``Tensor.__and__`` drops an
        # operand (bool DTensors, torch 2.13)
        mask = torch.logical_and(cpos <= pos1d, cpos >= 0)
        if window is not None:
            mask = torch.logical_and(mask, cpos > pos1d - window)
        out = _attend_dense(q, state["k"], state["v"], mask[:, None, None, :],
                            scale, cfg.logit_softcap)
    return dense(p["wo"], constrain(_flatten(out, (B, S, H * Dh)),
                                    "dp", None, "tp")), state


def constrain_cache(state: dict) -> dict:
    """Shard decode caches: batch over dp and cache-sequence over tp
    (context parallelism); for B=1 long-context decode the sequence dim
    takes both axes."""
    out = {}
    for name, c in state.items():
        if c.ndim >= 2 and c.shape[0] == 1:
            out[name] = constrain(c, None, "dpt", *([None] * (c.ndim - 2)))
        elif c.ndim >= 2:
            out[name] = constrain(c, "dp", "tp", *([None] * (c.ndim - 2)))
        else:
            out[name] = constrain(c, "dp")
    return out


def init_attn_cache(cfg: ModelConfig, B, max_len, *, window=None,
                    dtype=torch.bfloat16, device=None):
    """One attention layer's decode cache: ``k``, ``v`` (B, T, KV, Dh)
    zeros and ``pos_abs`` (B, T) int32, -1 marking an empty slot; T =
    min(window, max_len) when windowed, else max_len."""
    T = min(window, max_len) if window else max_len
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((B, T, KV, Dh), dtype=dtype, device=device),
        "v": torch.zeros((B, T, KV, Dh), dtype=dtype, device=device),
        "pos_abs": torch.full((B, T), -1, dtype=torch.int32, device=device),
    }


def _slots_write(state, bidx, slot, vals: dict, pos):
    for name, t in vals.items():
        state[name].index_put_((bidx, slot), t.to(state[name].dtype))
    state["pos_abs"].index_put_((bidx, slot), pos.to(torch.int32))
    return state


def _spec_of(t) -> tuple:
    """A DTensor's placements as a spec: each dim's mesh axes (in mesh
    order), None where it is not split."""
    from torch.distributed.tensor import Shard
    names = t.device_mesh.mesh_dim_names
    parts = [()] * t.ndim
    for i, pl in enumerate(t.placements):
        if isinstance(pl, Shard):
            parts[pl.dim] = parts[pl.dim] + (names[i],)
    return tuple(None if not a else a[0] if len(a) == 1 else a
                 for a in parts)


def _unflatten(t, shape):
    """``t.reshape(shape)``, ``shape`` splitting t's last dim. A DTensor
    whose last dim is split over axes whose size does not divide the
    first of the new dims is first gathered on that dim (DTensor cannot
    split a sharded dim unevenly)."""
    if is_dtensor(t):
        e = _spec_of(t)[-1]
        if e is not None:
            mesh = t.device_mesh
            n = math.prod(int(mesh.size(mesh.mesh_dim_names.index(a)))
                          for a in ((e,) if isinstance(e, str) else e))
            if shape[t.ndim - 1] % n:
                spec = _spec_of(t)[:-1] + (None,)
                t = t.redistribute(mesh, placements_of(spec, mesh))
    return t.reshape(shape)


def _slots_sharded(state, vals: dict, pos, append: bool):
    """The slot writes on a cache of DTensors, each rank writing the
    slots its shard holds (its rows over dp, its slots over tp or over
    every axis), in place into its local shard, as GSPMD writes the
    reference's scatter: the values and positions of its rows come to
    it (replicated over the cache's sequence axes). ``append``: one
    token a row, written where its slot is held (a where keeps the
    others' slot as it was); else the prefill's bulk fill, each held
    slot taking its last writer's values (the order-free rule of
    :func:`_slots_fill`)."""
    ref = state["pos_abs"]
    mesh = ref.device_mesh
    B, T = ref.shape
    spec = _spec_of(ref)
    row = (spec[0],)
    t0 = _shard_offset(T, spec[1], mesh)
    names = list(vals) + ["pos_abs"]
    locs = {n: state[n].to_local() for n in names}
    T_loc = locs["pos_abs"].shape[1]
    if T_loc == 0:
        return state
    pl = _local_of(pos, row + (None,), mesh)
    vl = {n: _local_of(t, row + (None,) * (t.ndim - 1), mesh)
          for n, t in vals.items()}
    vl["pos_abs"] = pl
    bl = pl.shape[0]
    if append:
        slot = (pl[:, 0] % T).long()
        inside = (slot >= t0) & (slot < t0 + T_loc)
        ls = (slot - t0).clamp(0, T_loc - 1)
        bidx = torch.arange(bl, device=pl.device)
        for n in names:
            dst, new = locs[n], vl[n][:, 0].to(locs[n].dtype)
            keep = inside.view(bl, *(1,) * (new.ndim - 1))
            dst.index_put_((bidx, ls), torch.where(keep, new, dst[bidx, ls]))
        return state
    pos = pl[:, -T:]
    slot = (pos % T).long()
    inside = (slot >= t0) & (slot < t0 + T_loc)
    ls = torch.where(inside, slot - t0, torch.full_like(slot, T_loc))
    j = torch.arange(slot.shape[1], dtype=torch.int32,
                     device=slot.device).expand_as(slot)
    last = torch.full((bl, T_loc + 1), -1, dtype=torch.int32,
                      device=slot.device)
    last.scatter_reduce_(1, ls, j, reduce="amax")
    last = last[:, :T_loc]
    has, src = last >= 0, last.clamp(min=0).long()
    for n in names:
        t = vl[n][:, -T:]
        new = t.gather(1, src.view(bl, T_loc, *(1,) * (t.ndim - 2))
                       .expand(bl, T_loc, *t.shape[2:]))
        dst = locs[n]
        keep = has.view(bl, T_loc, *(1,) * (t.ndim - 2))
        dst.copy_(torch.where(keep, new.to(dst.dtype), dst))
    return state


def _slots_append(state, vals: dict, pos):
    """Write one token (S == 1) of each tensor of ``vals`` (B, 1, ...)
    into ``state``'s tensor of that name, and pos (B, 1) into
    ``pos_abs``, at slot ``pos % T``: a ring buffer when windowed."""
    if is_dtensor(state["pos_abs"]):
        return constrain_cache(_slots_sharded(state, vals, pos, True))
    T = state["pos_abs"].shape[1]
    bidx = torch.arange(pos.shape[0], device=pos.device)
    return _slots_write(state, bidx, (pos[:, 0] % T).long(),
                        {n: t[:, 0] for n, t in vals.items()}, pos[:, 0])


def _slots_fill(state, vals: dict, pos):
    """Bulk prefill: write the last T positions of each tensor of
    ``vals`` (B, S, ...), each at ``pos % T``. Where positions share a
    slot the last of them wins, as in the reference (jax's scatter keeps
    the last update; a VLM prompt's patches all sit at position 0).
    ``index_put_`` with repeated indices leaves the winner undefined on
    CUDA, so every write to a slot first takes the last writer's values:
    each slot then receives one value, whatever the order. No sort and
    no host round trip: a ``scatter_reduce`` (amax, order-free) of the
    row index into a (B, T) table and one gather a tensor."""
    if is_dtensor(state["pos_abs"]):
        return constrain_cache(_slots_sharded(state, vals, pos, False))
    B, T = state["pos_abs"].shape
    pos = pos[:, -T:]
    slot = (pos % T).long()
    j = torch.arange(slot.shape[1], dtype=torch.int32,
                     device=slot.device).expand_as(slot)
    last = torch.full((B, T), -1, dtype=torch.int32, device=slot.device)
    last.scatter_reduce_(1, slot, j, reduce="amax")
    src = last.gather(1, slot).long()               # (B, S'): its writer

    def writer(t):
        t = t[:, -T:]
        return t.gather(1, src.view(*src.shape, *(1,) * (t.ndim - 2))
                        .expand_as(t))
    vals = {n: writer(t) for n, t in vals.items()}
    bidx = torch.arange(B, device=slot.device)[:, None]
    return _slots_write(state, bidx, slot, vals, pos.gather(1, src))


# ----------------------------------------------------------------------
# MLA (deepseek-v3): latent-compressed keys and values
# ----------------------------------------------------------------------


def init_mla(gen, cfg: ModelConfig, dtype=torch.bfloat16, lead=()):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    dev = _device(gen)
    return {
        "w_dq": dense_init(gen, d, m.q_lora_rank, dtype=dtype, lead=lead),
        "q_norm": norm_init(m.q_lora_rank, lead=lead, device=dev),
        "w_uq": dense_init(gen, m.q_lora_rank, H * qk_dim, dtype=dtype,
                           lead=lead),
        "w_dkv": dense_init(gen, d, m.kv_lora_rank, dtype=dtype, lead=lead),
        "kv_norm": norm_init(m.kv_lora_rank, lead=lead, device=dev),
        "w_kr": dense_init(gen, d, m.qk_rope_dim, dtype=dtype, lead=lead),
        "w_uk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_dim,
                           dtype=dtype, lead=lead),
        "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim,
                           dtype=dtype, lead=lead),
        "wo": dense_init(gen, H * m.v_head_dim, d, dtype=dtype, lead=lead),
    }


def _mla_rope(x, positions, cfg):
    """Full RoPE over all of x's (rope) dimensions, whatever cfg's style."""
    return apply_rope(x, positions, dataclasses.replace(
        cfg, rope_style="full", rope_frac=1.0))


def mla_apply(p, cfg: ModelConfig, x, positions, *, mode, state):
    """Multi-head latent attention; returns (y, state). The queries come
    through a rank-``q_lora_rank`` bottleneck; keys and values through
    the normed latent ``c`` (rank ``kv_lora_rank``) and one shared RoPE
    key ``kr`` (``qk_rope_dim``), which is all the cache holds.

    ``mode="full"`` rebuilds each head's keys (``qk_nope_dim`` from ``c``
    and ``kr``) and values (``v_head_dim``) for the whole sequence and
    runs flash attention; with a ``state`` (prefill) it writes ``c``,
    ``kr`` and the positions into the cache's slots ``pos % T``.
    ``mode="step"`` (decode) writes the token in place at ``pos % T`` and
    attends in the latent space (the absorbed form: ``w_uk`` folded into
    the query, ``w_uv`` applied after the weighted sum), in f32, over the
    slots holding positions ``<= pos``, without rebuilding per-head keys
    or values."""
    m = cfg.mla
    B, S, _ = x.shape
    H, nope, rope = cfg.num_heads, m.qk_nope_dim, m.qk_rope_dim
    pos1d = positions[..., 0] if positions.ndim == 3 else positions
    q = dense(p["w_uq"], apply_norm(p["q_norm"], dense(p["w_dq"], x)))
    q = q.reshape(B, S, H, nope + rope)
    q_nope = q[..., :nope]
    q_rope = _mla_rope(q[..., nope:], pos1d, cfg)
    c = apply_norm(p["kv_norm"], dense(p["w_dkv"], x))          # (B,S,r)
    k_rope = _mla_rope(dense(p["w_kr"], x)[:, :, None, :], pos1d,
                       cfg)[:, :, 0]                             # (B,S,e)
    scale = (nope + rope) ** -0.5
    if mode == "full":
        if state is not None:
            state = _slots_fill(state, {"c": c, "kr": k_rope}, pos1d)
        k_nope = dense(p["w_uk"], c).reshape(B, S, H, nope)
        val = dense(p["w_uv"], c).reshape(B, S, H, m.v_head_dim)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)],
                      -1)
        out = flash_attention(torch.cat([q_nope, q_rope], -1), k, val,
                              q_pos=pos1d, kv_pos=pos1d, causal=True,
                              window=None, scale=scale)
    elif mode == "step":
        state = _slots_append(state, {"c": c, "kr": k_rope}, pos1d)
        r = m.kv_lora_rank
        w_uk = p["w_uk"]["w"].reshape(r, H, nope).float()
        w_uv = p["w_uv"]["w"].reshape(r, H, m.v_head_dim).float()
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk)
        cf = state["c"].float()
        logits = (torch.einsum("bshr,btr->bhst", q_lat, cf)
                  + torch.einsum("bshe,bte->bhst", q_rope.float(),
                                 state["kr"].float())) * scale
        kv_pos = state["pos_abs"]
        mask = torch.logical_and(kv_pos <= pos1d,
                                 kv_pos >= 0)[:, None, None, :]
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        attn = torch.softmax(logits, dim=-1)                     # (B,H,1,T)
        out_lat = torch.einsum("bhst,btr->bshr", attn, cf)
        out = torch.einsum("bshr,rhv->bshv", out_lat, w_uv).to(x.dtype)
    else:
        raise ValueError(f"mla_apply: mode {mode!r}, not 'full' or 'step'")
    return dense(p["wo"], _flatten(out, (B, S, H * m.v_head_dim))), state


def init_mla_cache(cfg: ModelConfig, B, max_len, dtype=torch.bfloat16,
                   device=None):
    """One MLA layer's decode cache: the latent ``c`` (B, T, kv_lora_rank)
    and RoPE key ``kr`` (B, T, qk_rope_dim) zeros, and ``pos_abs`` (B, T)
    int32, -1 marking an empty slot; T = max_len."""
    m = cfg.mla
    return {
        "c": torch.zeros((B, max_len, m.kv_lora_rank), dtype=dtype,
                         device=device),
        "kr": torch.zeros((B, max_len, m.qk_rope_dim), dtype=dtype,
                          device=device),
        "pos_abs": torch.full((B, max_len), -1, dtype=torch.int32,
                              device=device),
    }

# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, d_ff=None, dtype=torch.bfloat16,
             lead=()):
    d_ff = d_ff or cfg.d_ff
    p = {"w_up": dense_init(gen, cfg.d_model, d_ff, bias=cfg.mlp_bias,
                            dtype=dtype, lead=lead),
         "w_down": dense_init(gen, d_ff, cfg.d_model, bias=cfg.mlp_bias,
                              dtype=dtype, lead=lead)}
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(gen, cfg.d_model, d_ff, bias=cfg.mlp_bias,
                                 dtype=dtype, lead=lead)
    return p


def mlp_apply(p, cfg: ModelConfig, x, act=None):
    """The (gated) MLP; ``act`` replaces the config's activation."""
    act = act or _ACTS[cfg.mlp_act]
    h = act(dense(p["w_up"], x)) if "w_gate" not in p else (
        act(dense(p["w_gate"], x)) * dense(p["w_up"], x))
    if h.ndim == 3:
        h = constrain(h, "dp", None, "tp")
    return dense(p["w_down"], h)

# ----------------------------------------------------------------------
# mixture of experts
# ----------------------------------------------------------------------


def init_moe(gen, cfg: ModelConfig, dtype=torch.bfloat16, lead=()):
    """The router (f32), the experts' stacked (E, ...) gated-MLP weights
    and, with ``num_shared``, one shared MLP of ``num_shared * d_expert``."""
    mo = cfg.moe
    d, dff, E = cfg.d_model, mo.d_expert, mo.num_experts
    p = {
        "router": dense_init(gen, d, E, dtype=torch.float32, lead=lead),
        "w_up": _normal(gen, (E, d, dff), 1.0 / math.sqrt(d), dtype, lead),
        "w_gate": _normal(gen, (E, d, dff), 1.0 / math.sqrt(d), dtype, lead),
        "w_down": _normal(gen, (E, dff, d), 1.0 / math.sqrt(dff), dtype,
                          lead),
    }
    if mo.num_shared:
        p["shared"] = init_mlp(gen, cfg, d_ff=mo.num_shared * dff,
                               dtype=dtype, lead=lead)
    return p


def _route(router_p, mo, xt):
    """The router over tokens xt (T, d): (gates (T, K) f32, experts (T, K),
    aux loss). The softmax of an f32 dense, its top K (``lax.top_k``'s:
    ties to the lower index, which a stable descending sort gives and
    ``torch.topk`` does not promise), renormalised; the Switch-style
    load-balance loss over all top-K assignments."""
    logits = dense(router_p, xt.float())                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :mo.top_k], experts[:, :mo.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    density = F.one_hot(experts, mo.num_experts).float().sum(1).mean(0) / (
        mo.top_k)
    aux = mo.num_experts * torch.sum(density * probs.mean(0)) * (
        mo.router_aux_coef)
    return gates, experts, aux


def _dispatch_tables(experts, gates, T, mo, C):
    """The reference's sort-based capacity dispatch: the assignments
    sorted stably by expert, each expert's first C kept, in token order.
    Returns the reference's tables, ``tok_idx`` (E, C) int32 and
    ``gate_val`` (E, C) (an empty slot holds token 0 and gate 0), and
    ``combine`` (T, K) int64: each token's kept slots as flat indices
    into (E * C), in expert order, a dropped assignment as E * C (sorted
    last)."""
    E, K = mo.num_experts, mo.top_k
    dev = experts.device
    flat_e = experts.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    se, order = torch.sort(flat_e, stable=True)
    st, sg = flat_t[order], gates.reshape(-1)[order]
    # bincount by a scatter: its length is E whatever the data (so that
    # a fake-tensor dry-run can size it)
    seg_counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, se, torch.ones_like(se))
    seg_start = torch.cumsum(seg_counts, 0) - seg_counts
    pos_in_seg = torch.arange(T * K, device=dev) - seg_start[se]
    keep = pos_in_seg < C
    slot_e = torch.where(keep, se, E)                          # overflow row
    slot_c = torch.where(keep, pos_in_seg, 0)
    # the kept (e, c) are unique; the dropped all land on (E, 0), cut off
    tok_idx = torch.zeros((E + 1, C), dtype=torch.int32, device=dev)
    tok_idx[slot_e, slot_c] = st.to(torch.int32)
    gate_val = torch.zeros((E + 1, C), dtype=gates.dtype, device=dev)
    gate_val[slot_e, slot_c] = torch.where(keep, sg, torch.zeros_like(sg))
    flat_slot = torch.where(keep, se * C + pos_in_seg, E * C)
    combine = torch.empty_like(flat_slot)
    combine[order] = flat_slot
    combine = combine.view(T, K).sort(dim=-1).values
    return tok_idx[:E], gate_val[:E], combine


# the experts' activations: silu as jax.nn.silu computes it in bf16, its
# sigmoid op by op (``_sigmoid``), so that a bf16 MoE block gives the
# reference's bits where its products do (with torch.sigmoid, rounded
# once, 275 of 1,000 normal bf16 inputs give another silu; the dense
# MLPs keep it, see ``_ACTS``). Its cost on the MoE archs' prefill and
# decode is within 2% on an H100 (bench/moe_silu.py, PERF.md)
_MOE_ACTS = {**_ACTS, "silu": lambda x: x * _sigmoid(x)}


def _expert_ffn(cfg, xe, wg, wu, wd):
    """The experts' gated MLPs, batched: xe (E, C, d) -> (E, C, d)."""
    act = _MOE_ACTS[cfg.mlp_act]
    return (act(xe @ wg) * (xe @ wu)) @ wd


def _capacity(mo, T, no_drop):
    if no_drop:
        return T * mo.top_k
    return max(1, int(mo.capacity_factor * mo.top_k * T / mo.num_experts))


def _combine(ye, combine):
    """Each token's sum of its kept slots' rows of ye (E * C, d) in expert
    order, every partial sum rounded to ye's dtype: the order in which
    the reference's scatter-add (flat (E, C) order) sums them, in a fixed
    order on every device (an atomic ``index_add_`` has none, and a bf16
    sum of deepseek's eight would change from run to run)."""
    n = ye.shape[0]
    y = torch.zeros((combine.shape[0], ye.shape[1]), dtype=ye.dtype,
                    device=ye.device)
    for j in range(combine.shape[1]):
        idx = combine[:, j]
        kept = (idx < n)[:, None]
        y = y + torch.where(kept, ye[idx.clamp(max=n - 1)],
                            torch.zeros((), dtype=ye.dtype, device=ye.device))
    return y


def moe_apply(p, cfg: ModelConfig, x, *, no_drop: bool = False):
    """The mixture-of-experts channel block; returns (y, aux_loss).

    Two paths, under the reference's condition: with a mesh bound whose
    data axes divide the batch and whose model axis divides the experts,
    the expert-parallel :func:`_moe_sharded`; otherwise the reference's
    single-device path: global routing, sort-based capacity dispatch
    (tokens over an expert's capacity dropped), every expert computing
    its whole (C, d) slab, the gated rows summed back per token, and the
    shared expert added. ``no_drop=True`` (a decode step) sizes the
    capacity at T * top_k, so that routing is exact. ``MOE_PATHS``
    counts the calls of each path."""
    mesh = AXES["mesh"]
    if mesh is not None and AXES["dp"] is not None:
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        dp_size = math.prod(sizes[a] for a in _dp_axes())
        if (x.shape[0] % dp_size == 0
                and cfg.moe.num_experts % sizes[AXES["tp"]] == 0):
            MOE_PATHS["sharded"] += 1
            return _moe_sharded(p, cfg, x, no_drop=no_drop)
    MOE_PATHS["global"] += 1
    if is_dtensor(x) or is_dtensor(p["w_up"]):
        return _moe_global_sharded(p, cfg, x, no_drop)
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    gates, experts, aux = _route(p["router"], mo, xt)
    C = _capacity(mo, T, no_drop)
    tok_idx, gate_val, combine = _dispatch_tables(experts, gates, T, mo, C)
    xe = constrain(xt[tok_idx.long()], "tp", None, None)     # (E,C,d)
    ye = _expert_ffn(cfg, xe, p["w_gate"], p["w_up"], p["w_down"])
    ye = ye * gate_val[..., None].to(ye.dtype)
    y = _combine(ye.reshape(-1, d), combine)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], cfg, xt, _MOE_ACTS[cfg.mlp_act])
    return y.reshape(B, S, d), aux


def _moe_global_sharded(p, cfg: ModelConfig, x, no_drop: bool):
    """The global path on DTensors (a batch the data axes do not divide:
    the B=1 long-context decode), as GSPMD runs it under the reference's
    constraint of the slabs to the model axis: every rank routes all the
    tokens, runs its own experts' slabs (its E/tp) and its column/row
    part of the shared expert, and the token sums are partial over the
    model axis; the aux loss is every rank's alike."""
    mo = cfg.moe
    mesh = (x if is_dtensor(x) else p["w_up"]).device_mesh
    tp = _tp_axes(mesh)
    tpe = tp[0] if len(tp) == 1 else tp
    B, S, d = x.shape
    T, E = B * S, mo.num_experts

    def loc(t, spec):
        return _local_of(t, spec, mesh, set(tp))
    xt = loc(x, (None, None, None)).reshape(T, d)
    gates, experts, aux = _route({"w": loc(p["router"]["w"], (None, None))},
                                 mo, xt)
    C = _capacity(mo, T, no_drop)
    tok_idx, gate_val, combine = _dispatch_tables(experts, gates, T, mo, C)
    wg, wu, wd = (loc(p[n], (tpe, None, None))
                  for n in ("w_gate", "w_up", "w_down"))
    e0, n_loc = _shard_offset(E, tpe, mesh), wg.shape[0]
    ye = _expert_ffn(cfg, xt[tok_idx[e0:e0 + n_loc].long()], wg, wu, wd)
    ye = ye * gate_val[e0:e0 + n_loc, ..., None].to(ye.dtype)
    lo, hi = e0 * C, (e0 + n_loc) * C
    mine = torch.where((combine >= lo) & (combine < hi), combine - lo,
                       torch.full_like(combine, n_loc * C))
    y = _combine(ye.reshape(-1, d), mine.sort(dim=-1).values)
    if "shared" in p:
        sh = p["shared"]
        act = _MOE_ACTS[cfg.mlp_act]
        h = act(xt @ loc(sh["w_gate"]["w"], (None, tpe))) * (
            xt @ loc(sh["w_up"]["w"], (None, tpe)))
        y = y + h @ loc(sh["w_down"]["w"], (tpe, None))
    y = _partial(y.reshape(B, S, d), mesh, (None, None, None), tpe,
                 (B, S, d), "sum")
    aux = _dtensor().from_local(aux, mesh, placements_of((), mesh),
                                run_check=False)
    return y, aux


class _AllToAll(torch.autograd.Function):
    """``Fabric.all_to_all`` differentiably: the gradient goes back by
    the inverse exchange (split and concat axes swapped)."""

    @staticmethod
    def forward(ctx, x, fabric, split_axis, concat_axis):
        ctx.args = (fabric, split_axis, concat_axis)
        return fabric.all_to_all(x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        fabric, a, b = ctx.args
        return fabric.all_to_all(g.contiguous(), b, a), None, None, None


class _SumReplicated(torch.autograd.Function):
    """The sum over a fabric's ranks of partial results into a value
    every rank then holds and uses alike (Megatron's row-parallel
    all-reduce): the gradient of each part is the value's own, as it
    is."""

    @staticmethod
    def forward(ctx, x, fabric):
        return fabric.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScaleGrad(torch.autograd.Function):
    """The identity, its gradient scaled by ``c``."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


class _MeanReplicated(torch.autograd.Function):
    """``pmean`` over a fabric's ranks, of a value every rank then holds
    alike: each part's gradient is the mean's over the rank count."""

    @staticmethod
    def forward(ctx, x, fabric):
        from repro_torch.comm.collectives import pmean
        ctx.K = fabric.K
        return pmean(x, fabric)

    @staticmethod
    def backward(ctx, g):
        return g / torch.full_like(g, float(ctx.K)), None


def _moe_sharded(p, cfg: ModelConfig, x, *, no_drop: bool):
    """Expert parallelism, the reference's ``shard_map`` body on each
    rank's own tensors: routing over the rank's data shard of the tokens
    (capacity from its T_loc), the (E, C_loc, d) slabs sent to the
    experts' owners by an all-to-all over the model axis, the E/tp local
    experts' MLPs, the all-to-all back, the gates and the fixed-order
    combine; the shared expert split column/row over the model axis and
    summed over it; the aux loss averaged over the data axes. ``x`` and
    the params are DTensors (or, on a mesh of one device, anything); the
    exchanges go through :class:`~repro_torch.comm.collectives.Fabric`
    (recorded in its log)."""
    from repro_torch.comm.collectives import data_fabric
    mo = cfg.moe
    mesh, tp, dp = AXES["mesh"], AXES["tp"], _dp_axes()
    B, S, d = x.shape
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp_size, tp_size = math.prod(sizes[a] for a in dp), sizes[tp]
    E = mo.num_experts
    if E % tp_size:
        raise ValueError(f"_moe_sharded: {E} experts over {tp_size}")
    T_loc = (B // dp_size) * S
    C_loc = _capacity(mo, T_loc, no_drop)
    dpe = dp if len(dp) > 1 else dp[0]
    # Gradients: every shard below is used differently on each rank of
    # the data and model axes, so its gradient is a partial sum over
    # them. The tp ranks of a data shard route the same tokens and run
    # them through the experts tp times over (each its own copy): that
    # path's gradient (and the router's aux loss's) is scaled by 1/tp,
    # so that the sums over tp give the one copy's; the shared expert's
    # column/row split is a true split and is not scaled.
    split = set(dp) | {tp}

    def loc(t, spec):
        return _local_of(t, spec, mesh, split)
    xt = loc(x, (dpe, None, None)).reshape(T_loc, d)
    wg, wu, wd = (loc(p[n], (tp, None, None))
                  for n in ("w_gate", "w_up", "w_down"))
    fab_tp, fab_dp = data_fabric(tp), data_fabric(dp)
    gates, experts, aux = _route({"w": loc(p["router"]["w"], (None, None))},
                                 mo, xt)
    tok_idx, gate_val, combine = _dispatch_tables(experts, gates, T_loc, mo,
                                                  C_loc)
    # expert slabs to their owners: (E, C, d) -> (E/tp, tp*C, d)
    xe = _AllToAll.apply(xt[tok_idx.long()], fab_tp, 0, 1)
    ye = _expert_ffn(cfg, xe, wg, wu, wd)
    ye = _AllToAll.apply(ye, fab_tp, 1, 0)
    ye = ye * gate_val[..., None].to(ye.dtype)
    y = _combine(ye.reshape(-1, d), combine)
    if tp_size > 1 and torch.is_grad_enabled():
        y = _ScaleGrad.apply(y, 1.0 / tp_size)
        aux = _ScaleGrad.apply(aux, 1.0 / tp_size)
    if "shared" in p:
        # shared expert: Megatron col/row split over tp + all-reduce
        sh = p["shared"]
        act = _MOE_ACTS[cfg.mlp_act]
        h = act(xt @ loc(sh["w_gate"]["w"], (None, tp))) * (
            xt @ loc(sh["w_up"]["w"], (None, tp)))
        y = y + _SumReplicated.apply(h @ loc(sh["w_down"]["w"], (tp, None)),
                                     fab_tp)
    aux = _MeanReplicated.apply(aux, fab_dp)
    if not (is_dtensor(x) or is_dtensor(p["w_up"])):
        return y.reshape(-1, S, d), aux      # this rank's rows
    DT = _dtensor()
    y = DT.from_local(y.reshape(-1, S, d), mesh,
                      placements_of((dpe, None, None), mesh), run_check=False,
                      shape=torch.Size((B, S, d)),
                      stride=contiguous_stride((B, S, d)))
    aux = DT.from_local(aux, mesh, placements_of((), mesh), run_check=False)
    return y, aux

# ----------------------------------------------------------------------
# causal depthwise conv1d (griffin / mamba2 frontends)
# ----------------------------------------------------------------------


def init_conv1d(gen, width, d, dtype=torch.bfloat16, lead=()):
    return {"w": _normal(gen, (width, d), 1.0 / math.sqrt(width), dtype,
                         lead),
            "b": torch.zeros((*lead, d), dtype=dtype, device=_device(gen))}


def conv1d_apply(p, x, *, mode, state):
    """x (B,S,d); ``state`` (B,width-1,d) holds the trailing context, or
    None. ``mode="full"`` pads width-1 zeros in front and writes the last
    width-1 rows of the padded input into ``state``; ``mode="step"``
    (S == 1) convolves the state and the token and shifts the token into
    the state. The state is written in place (in its own dtype) and
    returned. On DTensors each rank convolves its rows and channels (the
    weight's split; depthwise, so nothing crosses ranks)."""
    if not any(is_dtensor(t) for t in (x, p["w"], state)):
        return _conv1d_core(p["w"], p["b"], x, mode, state), state
    mesh = next(t for t in (p["w"], x, state) if is_dtensor(t)).device_mesh
    c = _spec_of(p["w"])[1] if is_dtensor(p["w"]) else None
    b = (_spec_of(state)[0] if is_dtensor(state)
         else logical_spec(x.shape, ("dp",))[0])
    if is_dtensor(state) and _spec_of(state) != (b, None, c):
        raise ValueError(f"conv1d_apply: state split {_spec_of(state)}, "
                         f"the weights' channels {c!r}")
    y = _local_call(
        lambda x, w, bias, st: _conv1d_core(w, bias, x, mode, st),
        [(x, (b, None, c)), (p["w"], (None, c)), (p["b"], (c,)),
         (state, None if state is None else (b, None, c))],
        [((b, None, c), tuple(x.shape))])
    return y, state


def _conv1d_core(w, bias, x, mode, state):
    width = w.shape[0]
    if mode == "full":
        xp = F.pad(x, (0, 0, width - 1, 0))
        y = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(width))
        if state is not None:
            state.copy_(xp[:, -(width - 1):])
        return y + bias
    ctx = torch.cat([state.to(x.dtype), x], 1)                 # (B,width,d)
    y = torch.einsum("bwd,wd->bd", ctx, w)[:, None] + bias
    state.copy_(ctx[:, 1:])
    return y

# ----------------------------------------------------------------------
# RG-LRU recurrent block (recurrentgemma / griffin)
# ----------------------------------------------------------------------


def init_rglru(gen, cfg: ModelConfig, dtype=torch.bfloat16, lead=()):
    width = cfg.rglru.lru_width or cfg.d_model
    d = cfg.d_model
    return {
        "w_x": dense_init(gen, d, width, dtype=dtype, lead=lead),
        "w_gate_branch": dense_init(gen, d, width, dtype=dtype, lead=lead),
        "conv": init_conv1d(gen, cfg.rglru.d_conv, width, dtype=dtype,
                            lead=lead),
        "w_rec_gate": dense_init(gen, width, width, dtype=dtype, lead=lead),
        "w_in_gate": dense_init(gen, width, width, dtype=dtype, lead=lead),
        # lam s.t. a = exp(-c*softplus(lam)) lands in ~(0.9, 0.999) at r=1
        "lam": torch.log(torch.expm1(_uniform(gen, (*lead, width), 0.0001,
                                              0.013))),
        "w_out": dense_init(gen, width, d, dtype=dtype, lead=lead),
    }


_RGLRU_C = 8.0


def _rglru_scan(x, r, i, lam):
    """x,r,i (B,S,W) f32. The scan over time of
    h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t * x_t), a_t = a^(c r_t), in
    ceil(log2 S) doubling passes (Hillis-Steele): pass o adds a_t h_{t-o}
    to h_t and multiplies a_t by a_{t-o}, each from the previous pass.
    The reference's ``lax.associative_scan`` computes the same
    recurrence in another rounding order."""
    log_a = -_RGLRU_C * r * _softplus(lam)                    # log a_t
    a = torch.exp(log_a)
    h = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * (
        i * x)
    o = 1
    while o < x.shape[1]:
        h = torch.cat([h[:, :o], h[:, o:] + a[:, o:] * h[:, :-o]], 1)
        a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], 1)
        o *= 2
    return h


def rglru_apply(p, cfg: ModelConfig, x, positions, *, mode, state):
    """Griffin recurrent block: gate branch (gelu) * recurrent branch
    (conv1d -> RG-LRU), then out-projection. ``state`` ({h (B,W) f32,
    conv (B,d_conv-1,W)}) is written in place and returned."""
    gate = constrain(_ACTS["gelu"](dense(p["w_gate_branch"], x)),
                     "dp", None, "tp")
    u = constrain(dense(p["w_x"], x), "dp", None, "tp")
    u, _ = conv1d_apply(p["conv"], u, mode=mode,
                        state=None if state is None else state["conv"])
    uf = u.float()
    r = _sigmoid(dense(p["w_rec_gate"], u).float())
    i = _sigmoid(dense(p["w_in_gate"], u).float())
    lam = p["lam"]
    if mode == "full":
        h = _rglru_scan(uf, r, i, lam)
        if state is not None:
            state["h"].copy_(h[:, -1])
    else:
        log_a = -_RGLRU_C * r[:, 0] * _softplus(lam)
        a = torch.exp(log_a)
        g = torch.sqrt(torch.clamp(1 - torch.exp(2 * log_a), min=1e-6)) * (
            i[:, 0] * uf[:, 0])
        h = state["h"].mul_(a).add_(g)[:, None]
    y = dense(p["w_out"], h.to(x.dtype) * gate)
    return y, state


def init_rglru_state(cfg: ModelConfig, B, dtype=torch.bfloat16,
                     device=None):
    width = cfg.rglru.lru_width or cfg.d_model
    return {"h": torch.zeros((B, width), dtype=torch.float32, device=device),
            "conv": torch.zeros((B, cfg.rglru.d_conv - 1, width),
                                dtype=dtype, device=device)}

# ----------------------------------------------------------------------
# Mamba-2 SSD block (state-space duality, chunked)
# ----------------------------------------------------------------------


def init_ssd(gen, cfg: ModelConfig, dtype=torch.bfloat16, lead=()):
    s = cfg.ssm
    d = cfg.d_model
    din = s.d_inner(d)
    nh = s.n_heads(d)
    conv_dim = din + 2 * s.n_groups * s.d_state
    return {
        # in_proj -> [z (din), x (din), B (G*N), C (G*N), dt (nh)]
        "w_in": dense_init(gen, d, 2 * din + 2 * s.n_groups * s.d_state + nh,
                           dtype=dtype, lead=lead),
        "conv": init_conv1d(gen, s.d_conv, conv_dim, dtype=dtype, lead=lead),
        "A_log": torch.log(_uniform(gen, (*lead, nh), 1.0, 16.0)),
        "D": torch.ones((*lead, nh), dtype=torch.float32,
                        device=_device(gen)),
        "dt_bias": torch.log(torch.expm1(_uniform(gen, (*lead, nh), 1e-3,
                                                  1e-1))),
        "out_norm": norm_init(din, lead=lead, device=_device(gen)),
        "w_out": dense_init(gen, din, d, dtype=dtype, lead=lead),
    }


def _ssd_chunked(x, dt, A, Bm, Cm, chunk):
    """Minimal SSD (mamba2 §6): x (B,S,H,P); dt (B,S,H); A (H,);
    Bm/Cm (B,S,G,N). Returns y (B,S,H,P), final_state (B,H,P,N).

    The reference's 4-operand einsums run here as pairwise products in
    the order of its equations, so that no (b,nc,c,c,H,P) tensor is
    made; the scan over chunks is a loop over them."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"_ssd_chunked: S={S} is not a multiple of "
                         f"chunk={chunk}")
    nc = S // chunk
    rep = H // G
    x_ = x.reshape(b, nc, chunk, H, P)
    dt_ = dt.reshape(b, nc, chunk, H)
    B_ = Bm.reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    C_ = Cm.reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    dA = dt_ * (-torch.exp(A))                                # (b,nc,c,H) <=0
    dA_cum = torch.cumsum(dA, dim=2)
    # intra-chunk (quadratic within chunk). Mask BEFORE exp: the
    # upper-triangle segments are positive and exp() of them overflows,
    # which poisons gradients (inf * 0 = NaN in the backward pass).
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (b,nc,c,c,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    Lm = torch.exp(torch.where(causal[:, :, None], seg,
                               torch.full_like(seg, -math.inf)))
    scores = torch.einsum("bzchn,bzshn->bzcsh", C_, B_)       # (b,nc,c,c,H)
    w = scores * Lm * dt_[:, :, None]                          # (b,nc,c,s,H)
    y_diag = torch.einsum("bzcsh,bzshp->bzchp", w, x_)
    # chunk end-states
    decay_to_end = torch.exp(dA_cum[:, :, -1:] - dA_cum)      # (b,nc,c,H)
    states = torch.einsum("bzchn,bzchp->bzhpn",
                          (decay_to_end * dt_)[..., None] * B_, x_)
    # inter-chunk recurrence over nc
    chunk_decay = torch.exp(dA_cum[:, :, -1])                  # (b,nc,H)
    h = torch.zeros((b, H, P, N), dtype=x.dtype, device=x.device)
    h_prev = []
    for z in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, z, :, None, None] + states[:, z]
    h_prev = torch.stack(h_prev, 1)                            # (b,nc,H,P,N)
    decay_in = torch.exp(dA_cum)                               # (b,nc,c,H)
    y_off = torch.einsum("bzchn,bzhpn->bzchp", C_, h_prev) * decay_in[
        ..., None]
    y = (y_diag + y_off).reshape(b, S, H, P)
    return y, h


def _ssd_core(xs, dt, Bm, Cm, dt_bias, A, D, h, mode, chunk):
    """The SSD between the conv and the gated norm, per (row, head): the
    chunked scan over the sequence (``mode="full"``; with a state ``h``
    its final value is written there) or one recurrent step, whose state
    ``h`` is updated in place; then the D skip. Returns y (B,S,nh,P)
    f32."""
    S, nh, G = xs.shape[1], xs.shape[2], Bm.shape[2]
    dt = _softplus(dt.float() + dt_bias)                       # (B,S,nh)
    if mode == "full":
        # the padded steps have dt = 0 (padded after the softplus): they
        # leave the final state unchanged
        pad = (-S) % chunk
        y, hT = _ssd_chunked(
            F.pad(xs.float(), (0, 0, 0, 0, 0, pad)),
            F.pad(dt, (0, 0, 0, pad)), A,
            F.pad(Bm.float(), (0, 0, 0, 0, 0, pad)),
            F.pad(Cm.float(), (0, 0, 0, 0, 0, pad)), chunk)
        y = y[:, :S]
        if h is not None:
            h.copy_(hT)
    else:
        # recurrent step: h = exp(dt A) h + dt B x ; y = C h
        dA = torch.exp(dt[:, 0] * (-torch.exp(A)))             # (B,nh)
        B_rep = Bm[:, 0].repeat_interleave(nh // G, dim=1)     # (B,nh,N)
        C_rep = Cm[:, 0].repeat_interleave(nh // G, dim=1)
        Bx = (B_rep.float()[:, :, None, :] * xs[:, 0].float()[..., None]
              * dt[:, 0, :, None, None])                       # (B,nh,P,N)
        h = h.mul_(dA[..., None, None]).add_(Bx)
        y = torch.einsum("bhpn,bhn->bhp", h, C_rep.float())[:, None]
    return y + xs.float() * D[None, None, :, None]


def ssd_apply(p, cfg: ModelConfig, x, positions, *, mode, state):
    """Mamba-2 block: in-projection, conv1d and silu over (x, B, C), the
    chunked SSD over the sequence (``mode="full"``) or one recurrent step
    (``"step"``), the D skip, a gated RMSNorm and the out-projection.
    ``state`` ({h (B,nh,P,N) f32, conv (B,d_conv-1,conv_dim)}) is written
    in place and returned."""
    s = cfg.ssm
    B, S, d = x.shape
    din = s.d_inner(d)
    nh = s.n_heads(d)
    G, N, P = s.n_groups, s.d_state, s.head_dim

    def silu(v):
        # the sigmoid op by op, as jax's: with torch.sigmoid, mamba2's
        # bf16 logits miss the reference's at 4.4-6.1x the elements its
        # own op-by-op run does (the count rule allows 2x)
        return v * _sigmoid(v)
    zxbcdt = dense(p["w_in"], x)
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * G * N, nh], dim=-1)
    xbc, _ = conv1d_apply(p["conv"], xbc, mode=mode,
                          state=None if state is None else state["conv"])
    xbc = silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [din, G * N, G * N], dim=-1)
    xs = constrain(_unflatten(xs, (B, S, nh, P)), "dp", None, "tp", None)
    Bm = _unflatten(Bm, (B, S, G, N))
    Cm = _unflatten(Cm, (B, S, G, N))
    h = None if state is None else state["h"]

    def core(xs, dt, Bm, Cm, dt_bias, A, D, h):
        return _ssd_core(xs, dt, Bm, Cm, dt_bias, A, D, h, mode, s.chunk)
    args = (xs, dt, Bm, Cm, p["dt_bias"], p["A_log"], p["D"], h)
    if any(is_dtensor(a) for a in args):
        # per (row, head): each rank runs its rows and heads (the
        # reference's constraint on xs), B and C whole, the state in
        # place in its own shard
        xspec = logical_spec(xs.shape, ("dp", None, "tp", None))
        if h is not None and is_dtensor(h):
            hs = _spec_of(h)
            xspec = (hs[0], None, hs[1], None)
        b, t = xspec[0], xspec[2]
        y = _local_call(core, [(xs, xspec), (dt, (b, None, t)),
                               (Bm, (b, None, None, None)),
                               (Cm, (b, None, None, None)), (p["dt_bias"],
                                                             (t,)),
                               (p["A_log"], (t,)), (p["D"], (t,)),
                               (h, None if h is None else (b, t, None, None))],
                        [(xspec, (B, S, nh, P))])
    else:
        y = core(*args)
    y = _flatten(y, (B, S, din)).to(x.dtype)
    y = apply_norm(p["out_norm"], y * silu(z))
    return dense(p["w_out"], y), state


def init_ssd_state(cfg: ModelConfig, B, dtype=torch.bfloat16, device=None):
    s = cfg.ssm
    d = cfg.d_model
    nh = s.n_heads(d)
    conv_dim = s.d_inner(d) + 2 * s.n_groups * s.d_state
    return {"h": torch.zeros((B, nh, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((B, s.d_conv - 1, conv_dim), dtype=dtype,
                                device=device)}
