"""Shared builders for the dry-run, the roofline and the partitioned
runs: params, shardings and step functions for every (arch x shape x
mesh) combination. The port of ``repro.launch.build``.

"Lowering" a step here builds its callable and its arguments as
DTensors placed by ``launch.sharding``'s specs: from real tensors
(``values=``, the same global values on every rank, each keeping its
shard), or, with none given, stand-ins made from the meta-device model
(:func:`~repro_torch.launch.sharding.abstract_distribute`, inside a
``FakeTensorMode`` for the dry-run). There is no compile step:
:meth:`Built.run` calls the step under :func:`partitioning`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.configs import (SHAPES, ModelConfig, ShapeConfig,
                                 get_config, input_specs)
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import data_axes
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.serve.decode import make_serve_step
from repro_torch.train.step import make_train_step
from repro_torch.utils.partitioning import bound, contiguous_stride, sub_mesh
from repro_torch.utils.trees import tree_map

# archs where a 500k-token full-attention decode is impossible and a
# sliding window is substituted (cfg.long_context == "swa")
LONG_WINDOW = 8192


@contextlib.contextmanager
def partitioning(mesh):
    """Bind the models' logical activation axes to this mesh (the data
    axes to ``dp``, ``model`` to ``tp``); plain tensors meeting DTensors
    inside count as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    with bound(dp=data_axes(mesh), tp="model", mesh=mesh), \
            implicit_replication():
        yield


@dataclass
class Built:
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Any
    step: Callable
    args: tuple
    kind: str
    notes: dict
    # the indices of ``args`` the step writes in place or returns
    # updated (the reference's donated arguments)
    donated: tuple = ()
    specs: tuple = field(default=())

    def run(self):
        """The step on its arguments under :func:`partitioning`."""
        with partitioning(self.mesh):
            return self.step(*self.args)


def shape_variant(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Adjust the arch config for a given input shape (SWA for 500k)."""
    if shape.name == "long_500k" and cfg.long_context == "swa":
        cfg = dataclasses.replace(cfg, sliding_window=LONG_WINDOW)
    return cfg


def supported(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k" and cfg.long_context == "skip":
        return False
    return True


def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    """bf16 optimizer state for the >100B configs; f32 elsewhere."""
    big = cfg.moe is not None or cfg.d_model >= 8192
    return AdamWConfig(state_dtype="bfloat16" if big else "float32")


def _place(tree, specs, mesh, values):
    """``values`` (real global tensors) distributed by ``specs``, or,
    with none, stand-ins of ``tree``'s meta tensors."""
    if values is None:
        return sh.abstract_distribute(tree, specs, mesh)
    return sh.distribute(values, specs, mesh)


def _pinned(step, pins: dict):
    """``step`` whose outputs at the positions of ``pins`` (output index
    -> the argument index it updates) come back placed as that argument
    is (the reference's ``out_shardings``): DTensor may leave an update
    placed otherwise (a gradient reduced by a reduce-scatter, a cache
    constrained anew)."""
    def placed_as(out, arg):
        from torch.distributed.tensor import DTensor
        if isinstance(out, DTensor) and tuple(out.placements) != tuple(
                arg.placements):
            return out.redistribute(arg.device_mesh, arg.placements)
        return out

    def run(*args):
        outs = list(step(*args))
        for o, a in pins.items():
            outs[o] = sh.map_specs(placed_as, outs[o], args[a])
        return tuple(outs)
    return run


def _meta_params(model):
    with torch.device("meta"):
        return model.init(None)


def abstract_train_args(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                        fsdp: bool):
    model = build_model(cfg)
    opt_cfg = opt_config_for(cfg)
    params_s = _meta_params(model)
    opt_s = adamw_init(params_s, opt_cfg)
    batch_s = dict(input_specs(cfg, shape))
    p_specs = sh.param_specs(params_s, mesh, fsdp=fsdp)
    o_specs = {
        "mu": sh.param_specs(opt_s["mu"], mesh, fsdp=fsdp),
        "nu": sh.param_specs(opt_s["nu"], mesh, fsdp=fsdp),
        "count": (),
    }
    b_specs = sh.batch_specs(batch_s, mesh)
    return model, opt_cfg, (params_s, opt_s, batch_s), (p_specs, o_specs,
                                                        b_specs)


def lower_train(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                fsdp: bool | None = None, remat: bool = True,
                unroll: bool = False, donate: bool = True,
                microbatch: int | None = None, values=None,
                opt_cfg: AdamWConfig | None = None, schedule=None):
    """One train step: ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``. ``values``: real ``(params, opt_state,
    batch)``; ``opt_cfg`` replaces :func:`opt_config_for`'s and
    ``schedule`` the step's default lr schedule."""
    del unroll                  # the port's forward is always unrolled
    cfg = shape_variant(cfg, shape)
    if fsdp is None:
        fsdp = cfg.moe is not None or cfg.d_model >= 6144
    if microbatch is None:
        # gradient accumulation for the activation-heavy giants
        microbatch = 4 if (cfg.moe is not None or cfg.d_model >= 7168) else 1
    model, opt_d, trees, specs = abstract_train_args(cfg, shape, mesh,
                                                     fsdp=fsdp)
    opt_cfg = opt_cfg or opt_d
    step = make_train_step(model, opt_cfg, remat=remat,
                           microbatch=microbatch, schedule=schedule)
    args = tuple(_place(t, s, mesh, None if values is None else v)
                 for t, s, v in zip(trees, specs, values or (None,) * 3))
    return Built(cfg, shape, mesh, _pinned(step, {0: 0, 1: 1}), args,
                 "train",
                 {"fsdp": fsdp, "remat": remat, "microbatch": microbatch,
                  "opt_dtype": opt_cfg.state_dtype},
                 donated=(0, 1) if donate else (), specs=specs)


def _on_sub_mesh(tree, mesh, sub):
    """Each DTensor of ``tree`` on ``mesh`` as one on ``sub``, its
    ``model`` sub-mesh: the same local shard, under its ``model``
    placement, and whole along the dims the data axes split (this rank's
    rows are all the sub-mesh sees)."""
    from torch.distributed.tensor import DTensor
    i = mesh.mesh_dim_names.index("model")

    def one(t):
        if not isinstance(t, DTensor):
            return t
        local, pl = t.to_local(), t.placements[i]
        data_dims = {q.dim for j, q in enumerate(t.placements)
                     if j != i and q.is_shard()}
        assert not (pl.is_shard() and pl.dim in data_dims), t.placements
        shape = tuple(local.shape[d] if d in data_dims else t.shape[d]
                      for d in range(t.ndim))
        return DTensor.from_local(local, sub, [pl], run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))
    return tree_map(one, tree)


def _on_full_mesh(tree, mesh):
    """The inverse of :func:`_on_sub_mesh` for trees replicated over the
    data axes (params, optimizer state)."""
    from torch.distributed.tensor import DTensor, Replicate
    i = mesh.mesh_dim_names.index("model")

    def one(t):
        if not isinstance(t, DTensor):
            return t
        pl = [Replicate()] * mesh.ndim
        pl[i] = t.placements[0]
        return DTensor.from_local(t.to_local(), mesh, pl, run_check=False,
                                  shape=t.shape,
                                  stride=contiguous_stride(t.shape))
    return tree_map(one, tree)


def lower_train_local_updates(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                              H: int, remat: bool = True,
                              codec: str = "f32", values=None,
                              opt_cfg: AdamWConfig | None = None,
                              schedule=None):
    """The paper's technique at transformer scale: H local optimizer
    steps per parameter synchronization, the round
    (``local_updates_round``) run with ``axis_name`` the data axes: the
    params and opt state split over ``model`` only, the batches (H, B,
    ...) over the data axes on B, and the exchange over the data axes'
    group. ``values``: real ``(params, opt_state, batches)``."""
    from repro_torch.comm.collectives import data_fabric
    from repro_torch.optim.local_updates import (LocalUpdatesConfig,
                                                 local_updates_round)
    cfg = shape_variant(cfg, shape)
    model, opt_d, (params_s, opt_s, batch_s), (p_sp, o_sp, _) = \
        abstract_train_args(cfg, shape, mesh, fsdp=False)
    opt_cfg = opt_cfg or opt_d
    dp = data_axes(mesh)
    batch_H = {k: torch.empty((H, *v.shape), dtype=v.dtype, device="meta")
               for k, v in batch_s.items()}
    b_sp = {k: (None, dp) + (None,) * (v.ndim - 2)
            for k, v in batch_H.items()}
    step = make_train_step(model, opt_cfg, remat=remat, schedule=schedule)
    lu_cfg = LocalUpdatesConfig(H=H, codec=codec)

    def round_fn(params, opt_state, batches):
        # the data axes manual, as in the reference's shard_map: each data
        # rank steps on its own rows with its own optimizer, the trees on
        # the model sub-mesh (DTensor's there), the exchange over the data
        # axes' group
        fabric = data_fabric(dp)
        sub = sub_mesh(mesh, ("model",))
        params, opt_state, batches = (_on_sub_mesh(t, mesh, sub) for t in
                                      (params, opt_state, batches))
        with bound(None, "model", sub):
            params, opt_state, metrics = local_updates_round(
                step, params, opt_state, batches, lu_cfg, fabric)
        return (_on_full_mesh(params, mesh), _on_full_mesh(opt_state, mesh),
                {k: (v[-1] if isinstance(v, torch.Tensor) and v.ndim else v)
                 for k, v in metrics.items()})

    trees, specs = (params_s, opt_s, batch_H), (p_sp, o_sp, b_sp)
    args = tuple(_place(t, s, mesh, None if values is None else v)
                 for t, s, v in zip(trees, specs, values or (None,) * 3))
    return Built(cfg, shape, mesh, _pinned(round_fn, {0: 0, 1: 1}), args,
                 "train_localH",
                 {"H": H, "remat": remat, "codec": codec},
                 donated=(0, 1), specs=specs)


def abstract_decode_args(cfg: ModelConfig, shape: ShapeConfig, mesh):
    """(model, params, states, tokens, positions) on the meta device;
    whisper's states from its encoder run on meta frames."""
    model = build_model(cfg)
    params_s = _meta_params(model)
    B, S = shape.global_batch, shape.seq_len
    max_len = S if cfg.sliding_window is None else min(S, cfg.sliding_window)
    specs = input_specs(cfg, shape)
    with torch.device("meta"):
        if cfg.family == "audio":
            enc = {"frame_embeds": torch.empty(
                (B, cfg.encdec.source_len, cfg.d_model),
                dtype=torch.bfloat16)}
            states_s = model.init_states(params_s, B, max_len, batch=enc)
        else:
            states_s = model.init_states(params_s, B, max_len)
    return model, params_s, states_s, specs["tokens"], specs["positions"]


def lower_decode(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                 unroll: bool = False, donate: bool = True,
                 fsdp: bool | None = None, values=None):
    """One decode step: ``(params, states, tokens, positions) -> (logits,
    states)``, the states written in place. ``values``: real ``(params,
    states, tokens, positions)``."""
    del unroll
    cfg = shape_variant(cfg, shape)
    model, params_s, states_s, tokens_s, pos_s = \
        abstract_decode_args(cfg, shape, mesh)
    if fsdp is None:
        # >100B params don't fit 16-way model sharding at 2 bytes/param;
        # shard weights over the data axes too (weight-gathered serving)
        fsdp = cfg.moe is not None
    p_sp = sh.param_specs(params_s, mesh, fsdp=fsdp)
    s_sp = sh.state_specs(states_s, mesh)
    t_sp = sh.batch_specs({"t": tokens_s, "p": pos_s}, mesh)
    trees = (params_s, states_s, tokens_s, pos_s)
    specs = (p_sp, s_sp, t_sp["t"], t_sp["p"])
    args = tuple(_place(t, s, mesh, None if values is None else v)
                 for t, s, v in zip(trees, specs, values or (None,) * 4))
    step = make_serve_step(model)

    def serve_step(params, states, tokens, positions):
        with torch.no_grad():
            return step(params, states, tokens, positions)
    return Built(cfg, shape, mesh, _pinned(serve_step, {1: 1}), args,
                 "decode",
                 {"fsdp": fsdp}, donated=(1,) if donate else (),
                 specs=specs)


def lower_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                  donate: bool = True, unroll: bool = False,
                  fsdp: bool | None = None, values=None,
                  last_logits_only: bool = True):
    """The prompt's forward into decode states: ``(params, batch, states)
    -> (logits, states)``. The states (:func:`abstract_decode_args`'s
    at the prompt's length, placed by ``state_specs``) are an argument
    the step fills in place, where the reference makes them inside its
    step. ``values``: real ``(params, batch, states)``."""
    cfg = shape_variant(cfg, shape)
    model = build_model(cfg)
    params_s = _meta_params(model)
    batch_s = dict(input_specs(cfg, shape))
    if fsdp is None:
        fsdp = cfg.moe is not None  # weight-gathered serving for >100B
    B, S = batch_s["tokens"].shape
    with torch.device("meta"):
        states_s = model.init_states(
            params_s, B, S, batch=batch_s if cfg.family == "audio" else None)
    p_sp = sh.param_specs(params_s, mesh, fsdp=fsdp)
    b_sp = sh.batch_specs(batch_s, mesh)
    s_sp = sh.state_specs(states_s, mesh)
    trees, specs = (params_s, batch_s, states_s), (p_sp, b_sp, s_sp)
    args = tuple(_place(t, s, mesh, None if values is None else v)
                 for t, s, v in zip(trees, specs, values or (None,) * 3))

    def prefill(params, batch, states):
        # serving needs only the last-position logits; skipping the
        # full (B, S, V) unembed saves tens of GB at 32k prefill
        with torch.no_grad():
            return model.prefill(params, batch, states,
                                 last_logits_only=last_logits_only)
    return Built(cfg, shape, mesh, _pinned(prefill, {1: 2}), args,
                 "prefill",
                 {"fsdp": fsdp}, donated=(2,) if donate else (),
                 specs=specs)


def lower_cfg(cfg: ModelConfig, shape: ShapeConfig, mesh, **kw) -> Built:
    """The step of ``shape``'s kind for ``cfg``."""
    if shape.kind == "train":
        return lower_train(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return lower_prefill(cfg, shape, mesh, **kw)
    return lower_decode(cfg, shape, mesh, **kw)


def lower_pair(arch: str, shape_name: str, mesh, **kw) -> Built | None:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not supported(cfg, shape):
        return None
    return lower_cfg(cfg, shape, mesh, **kw)
