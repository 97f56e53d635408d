"""The port's mesh layer (``repro_torch.launch.mesh``, ``.sharding``,
``.build``, ``.roofline``'s ``model_flops``), ``Fabric.all_to_all`` and
the partitioned model paths, held against the reference.

One subprocess runs the reference once, on 8 faked host devices: every
spec of ``repro.launch.sharding`` for the ten archs at full width on
the (16, 16) and (2, 16, 16) abstract meshes (params with ``fsdp`` off
and on, decode states at ``decode_32k`` and ``long_500k``, inputs),
``input_specs``, ``shape_variant``, ``supported``, ``opt_config_for``
and ``model_flops`` for the 40 (arch x shape) pairs, ``lax.all_to_all``
(tiled) on 4 devices and ``_moe_sharded`` at deepseek-v3 ``.reduced()``
in f32 on a (2, 4) mesh. One spawned group of 4 gloo ranks (a (2, 2)
``("data", "model")`` mesh, one CPU thread a rank) runs the all-to-all,
the partitioned tinyllama ``.reduced()`` and one ``.reduced()`` arch of
each other family (loss, gradients, a prefill and a decode step), and
one ``lower_train_local_updates`` round under ``int8`` beside the
unpartitioned round over the data group; one of 8 ranks (a (2, 4) mesh)
runs ``_moe_sharded``.
"""
import contextlib
import math
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, SHAPES, get_config, input_specs
from repro_torch.launch import build
from repro_torch.launch import sharding as sh
from repro_torch.launch.dist import spawn
from repro_torch.launch.mesh import abstract_mesh
from repro_torch.launch.roofline import model_flops
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.utils.partitioning import set_partitioning

ROOT = os.path.join(os.path.dirname(__file__), "..")
MESHES = {"sp": ((16, 16), ("data", "model")),
          "mp": ((2, 16, 16), ("pod", "data", "model"))}
STATE_SHAPES = ("decode_32k", "long_500k")

REFERENCE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.configs import ARCHS, SHAPES, get_config, input_specs
from repro.launch import build, sharding as sh
from repro.launch.roofline import model_flops
from repro.models import build_model, layers as L
from repro.utils import compat

def norm(spec):
    return tuple(None if e is None else e if isinstance(e, str)
                 else tuple(e) for e in spec)

def names(path):
    out = []
    for p in path:
        if hasattr(p, "key"):
            out.append(str(p.key))
        elif hasattr(p, "idx"):
            out.append(str(p.idx))
    return "/".join(out)

def flat(specs):
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))[0]
    return {names(p): norm(s) for p, s in leaves}

MESHES = {"sp": ((16, 16), ("data", "model")),
          "mp": ((2, 16, 16), ("pod", "data", "model"))}
out = {"params": {}, "states": {}, "batch": {}, "inputs": {}, "pure": {}}
def decode_states(cfg, s, mesh):
    # abstract_decode_args' states, without its second eval of the init
    # for the decoder-only archs
    if cfg.family == "audio":
        return build.abstract_decode_args(cfg, s, mesh)[2]
    B, S = s.global_batch, s.seq_len
    T = S if cfg.sliding_window is None else min(S, cfg.sliding_window)
    return jax.eval_shape(lambda: build_model(cfg).init_states(None, B, T))

for arch in ARCHS:
    cfg = get_config(arch)
    params = jax.eval_shape(lambda k: build_model(cfg).init(k),
                            jax.random.key(0))
    states = {}
    for sname in ("decode_32k", "long_500k"):
        s = SHAPES[sname]
        if build.supported(cfg, s):
            states[sname] = decode_states(build.shape_variant(cfg, s), s,
                                          None)
    for mk, (shape, axes) in MESHES.items():
        mesh = compat.abstract_mesh(shape, axes)
        for fsdp in (False, True):
            out["params"][arch, mk, fsdp] = flat(
                sh.param_specs(params, mesh, fsdp=fsdp))
        for sname, st in states.items():
            out["states"][arch, mk, sname] = flat(sh.state_specs(st, mesh))
        for sname, s in SHAPES.items():
            out["batch"][arch, mk, sname] = flat(
                sh.batch_specs(input_specs(cfg, s), mesh))
    for sname, s in SHAPES.items():
        out["inputs"][arch, sname] = {
            k: (tuple(v.shape), str(v.dtype))
            for k, v in input_specs(cfg, s).items()}
        c = build.shape_variant(cfg, s)
        out["pure"][arch, sname] = dict(
            sliding_window=c.sliding_window,
            supported=build.supported(cfg, s),
            opt_dtype=build.opt_config_for(cfg).state_dtype,
            model_flops=float(model_flops(c, s)))

# lax.all_to_all (tiled) on 4 devices: device r's block is r * 1000 +
# arange, shaped (4, 8, 12)
mesh4 = Mesh(np.array(jax.devices()[:4]), ("x",))
blocks = np.stack([r * 1000 + np.arange(4 * 8 * 12, dtype=np.float32)
                   .reshape(4, 8, 12) for r in range(4)])
out["a2a"] = {}
for split, concat in ((0, 1), (1, 0), (2, 0), (1, 2)):
    f = compat.shard_map(
        lambda b, s=split, c=concat: jax.lax.all_to_all(
            b[0], "x", s, c, tiled=True)[None],
        mesh4, in_specs=P("x"), out_specs=P("x"))
    out["a2a"][split, concat] = np.asarray(jax.jit(f)(jnp.asarray(blocks)))
out["a2a_in"] = blocks

# the reference's expert-parallel MoE on a (2, 4) mesh
cfg = get_config("deepseek-v3-671b").reduced()
mesh = compat.make_mesh((2, 4), ("data", "model"))
p = L.init_moe(jax.random.key(0), cfg, jnp.float32)
x = jax.random.normal(jax.random.key(1), (4, 16, cfg.d_model),
                      jnp.float32) * 0.1
L.set_partitioning(dp=("data",), tp="model", mesh=mesh)
with mesh:
    y1, aux1 = jax.jit(lambda p, x: L.moe_apply(p, cfg, x))(p, x)
L.set_partitioning()
y2, aux2 = L.moe_apply(p, cfg, x)
out["moe"] = dict(params=jax.tree.map(np.asarray, p), x=np.asarray(x),
                  y_sharded=np.asarray(y1), aux_sharded=float(aux1),
                  y_global=np.asarray(y2))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    import pickle
    path = str(tmp_path_factory.mktemp("sharding") / "ref.pkl")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE, path],
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    with open(path, "rb") as f:
        return pickle.load(f)


def _flat(specs) -> dict:
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (str(k),))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = t
    walk(specs, ())
    return out


def _meta_params(arch):
    with torch.device("meta"):
        return build_model(get_config(arch)).init(None)


# -- specs, leaf for leaf -------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(ref, arch):
    params = _meta_params(arch)
    for mk, (shape, axes) in MESHES.items():
        mesh = abstract_mesh(shape, axes)
        for fsdp in (False, True):
            got = _flat(sh.param_specs(params, mesh, fsdp=fsdp))
            assert got == ref["params"][arch, mk, fsdp], (mk, fsdp)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference(ref, arch):
    """Decode states at decode_32k (B = 128) and long_500k (B = 1: the
    sequence over every axis), on both meshes."""
    cfg = get_config(arch)
    n = 0
    for mk, (shape, axes) in MESHES.items():
        mesh = abstract_mesh(shape, axes)
        for sname in STATE_SHAPES:
            s = SHAPES[sname]
            if not build.supported(cfg, s):
                assert (arch, mk, sname) not in ref["states"]
                continue
            c = build.shape_variant(cfg, s)
            _, _, states, _, _ = build.abstract_decode_args(c, s, mesh)
            assert _flat(sh.state_specs(states, mesh)) == \
                ref["states"][arch, mk, sname], (mk, sname)
            n += 1
    assert n >= 2


@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_and_batch_specs_match_reference(ref, arch):
    cfg = get_config(arch)
    for sname, s in SHAPES.items():
        specs = input_specs(cfg, s)
        assert all(v.is_meta for v in specs.values())
        got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for k, v in specs.items()}
        assert got == ref["inputs"][arch, sname], sname
        for mk, (shape, axes) in MESHES.items():
            assert _flat(sh.batch_specs(specs, abstract_mesh(shape, axes))) \
                == ref["batch"][arch, mk, sname], (mk, sname)


@pytest.mark.parametrize("arch", ARCHS)
def test_build_rules_and_model_flops_match_reference(ref, arch):
    cfg = get_config(arch)
    for sname, s in SHAPES.items():
        c = build.shape_variant(cfg, s)
        want = ref["pure"][arch, sname]
        assert c.sliding_window == want["sliding_window"], sname
        assert build.supported(cfg, s) == want["supported"], sname
        assert build.opt_config_for(cfg).state_dtype == want["opt_dtype"]
        assert float(model_flops(c, s)) == want["model_flops"], sname


def test_placements_and_local_shapes():
    from torch.distributed.tensor import Replicate, Shard
    mesh = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert sh.placements_of((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert sh.placements_of((None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        sh.placements_of((("data", "pod"),), mesh)
    # rank 0's shard is the ceil-divided one; the last ranks' may be empty
    assert sh.local_shape((40, 7), ("model", None), mesh) == (3, 7)
    assert sh.local_shape((40, 7), ("model", None), mesh,
                          {"pod": 0, "data": 0, "model": 15}) == (0, 7)
    assert sh.local_shape((524288, 8), ((("pod", "data", "model")), None),
                          mesh) == (1024, 8)


def test_data_fabric_refuses_an_unbound_axis_name():
    from repro_torch.comm.collectives import data_fabric
    set_partitioning(None, None)
    for axis in ("data", ("pod", "data")):
        with pytest.raises(NameError, match="unbound axis name"):
            data_fabric(axis)
    with pytest.raises(TypeError, match="mesh-axis names"):
        data_fabric(3)


# -- the 4-rank group: all-to-all, partitioned tinyllama, local updates ---

B, S = 8, 32


# one arch of each family whose DTensor branches the dense tinyllama does
# not reach: tied embeddings (command-r), conv1d and SSD (mamba2), RG-LRU
# and local attention (recurrentgemma), MLA, MoE and MTP (deepseek-v3),
# whisper's encoder, cross-attention and tied unembedding
FAMILIES = ("command-r-35b", "mamba2-2.7b", "recurrentgemma-9b",
            "deepseek-v3-671b", "whisper-tiny")


def _cfgs():
    base = get_config("tinyllama-1.1b").reduced()
    # 8 heads over the model axis: 4 a rank, each pair over one of 2 kv
    # heads (the GQA split the reduced config's 4 heads skip)
    out = {"reduced": base,
           "heads8": replace(base, num_heads=8, head_dim=32)}
    for arch in FAMILIES:
        cfg = get_config(arch).reduced()
        if cfg.moe is not None:
            # no drops and no aux term: the sharded block routes each data
            # shard alone (local capacity, the shard's own aux loss), the
            # reference's semantics, which the MoE tests below hold
            cfg = replace(cfg, moe=replace(
                cfg.moe, capacity_factor=float(cfg.moe.num_experts),
                router_aux_coef=0.0))
        out[arch] = cfg
    return out


def _runs(cfg, params, inputs, mesh=None):
    """Loss, gradients, the prefill's logits and one decode step's, of
    the unpartitioned port, or under ``partitioning(mesh)`` with params,
    batches and states placed by the reference's specs (every output
    gathered whole)."""
    from repro_torch.train.step import loss_and_grads
    m = build_model(cfg)
    batch = dict(inputs["batch"])
    extras = {}
    if cfg.family == "audio":
        extras = {"frame_embeds": inputs["frames"]}
        batch.update(extras)
    with torch.no_grad():
        st = m.init_states(params, B, S, batch=extras or None,
                           dtype=torch.float32)
    prompt, nxt = {"tokens": inputs["prompt"], **extras}, inputs["next"]
    ctx = contextlib.nullcontext()
    if mesh is not None:
        def place(tree, specs):
            return sh.distribute(tree, specs(tree, mesh), mesh)
        params = place(params, sh.param_specs)
        batch, prompt, nxt = (place(b, sh.batch_specs)
                              for b in (batch, prompt, nxt))
        st = place(st, sh.state_specs)
        ctx = build.partitioning(mesh)
    with ctx:
        loss, _, grads = loss_and_grads(m, params, batch)
        with torch.no_grad():
            lg0, st = m.prefill(params, prompt, st)
            lg1, _ = m.decode_step(params, nxt, st)

    def whole(t):
        return t.full_tensor() if mesh is not None else t
    return dict(loss=whole(loss), grads=[whole(g) for g in grads],
                prefill=whole(lg0), step=whole(lg1))


def _mesh4_rank(rank, world, device, inputs):
    import torch.distributed as tdist

    from repro_torch.comm.collectives import Fabric, data_fabric, recording
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import local_updates as LU
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.train.step import loss_and_grads
    from repro_torch.utils.trees import tree_leaves
    out = {}
    # Fabric.all_to_all against lax.all_to_all(tiled=True)
    fab = Fabric()
    blk = torch.from_numpy(inputs["a2a_in"][rank])
    with recording() as log:
        out["a2a"] = {k: fab.all_to_all(blk, *k).numpy()
                      for k in ((0, 1), (1, 0), (2, 0), (1, 2))}
    out["a2a_log"] = [(c.op, c.nbytes, c.K) for c in log]
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    with build.partitioning(mesh):
        out["fabric_sizes"] = (data_fabric("data").K, data_fabric("model").K,
                               data_fabric(("data", "model")).K)
    # the partitioned tinyllama and the families: loss, grads, prefill
    # and one decode step
    for name, cfg in _cfgs().items():
        out[name] = _runs(cfg, inputs[name], inputs, mesh)
    # one local-updates round under int8 with params split over model,
    # then the same round unpartitioned over the data group (each data
    # rank on its own rows), and the unpartitioned exchange of the
    # partitioned round's deltas
    from repro_torch.comm import get_codec
    from repro_torch.train.step import make_train_step
    cfg = _cfgs()["reduced"]
    params = inputs["reduced"]
    opt_cfg = AdamWConfig(lr=1e-3)
    seen = {"part": [], "plain": []}
    run = ["part"]
    orig = LU._codec_mean

    def spy(delta, codec, fabric, state=None):
        res = orig(delta, codec, fabric, state)
        seen[run[0]].append((delta.clone(), res[0], res[2]))
        return res
    LU._codec_mean = spy
    try:
        built = build.lower_train_local_updates(
            cfg, SHAPES["train_4k"], mesh, H=2, codec="int8",
            opt_cfg=opt_cfg, values=(params, adamw_init(params, opt_cfg),
                                     inputs["batches"]))
        p_part, _, _ = built.run()
        run[0] = "plain"
        d, rows = mesh.get_coordinate()[0], B // 2
        mine = {k: v[:, d * rows:(d + 1) * rows]
                for k, v in inputs["batches"].items()}
        p_plain, _, _ = LU.local_updates_round(
            make_train_step(build_model(cfg), opt_cfg, remat=True), params,
            adamw_init(params, opt_cfg), mine,
            LU.LocalUpdatesConfig(H=2, codec="int8"),
            Fabric(mesh["data"].get_group()))
    finally:
        LU._codec_mean = orig
    codec, dfab = get_codec("int8"), Fabric(mesh["data"].get_group())
    replay = [orig(delta, codec, dfab) for delta, _, _ in seen["part"]]
    out["lu"] = dict(
        leaf_numel=[t.numel() for t in tree_leaves(params)],
        delta_numel=[delta.numel() for delta, _, _ in seen["part"]],
        part=[(m, g) for _, m, g in seen["part"]],
        replay=[(m, g) for m, _, g in replay],
        plain=[(m, g) for _, m, g in seen["plain"]],
        dbg=[(a[0], b[0]) for a, b in zip(seen["part"], seen["plain"])],
        params_part=[t.full_tensor() for t in tree_leaves(p_part)],
        params_plain=tree_leaves(p_plain),
        placements_kept=all(a.placements == b.placements for a, b in zip(
            tree_leaves(p_part), tree_leaves(built.args[0]))))
    del tdist
    return out


@pytest.fixture(scope="module")
def mesh4(ref, tmp_path_factory):
    from repro_torch.data.tokens import TokenStream
    torch.manual_seed(0)
    ts = TokenStream(512, S, B, seed=0)
    b = ts.next_batch()
    batch = {k: torch.tensor(v) for k, v in b.items()}
    inputs = {"a2a_in": ref["a2a_in"], "batch": batch,
              "prompt": batch["tokens"][:, :S // 2].contiguous(),
              "next": {"tokens": batch["tokens"][:, S // 2:S // 2 + 1]
                       .contiguous(),
                       "positions": torch.full((B, 1), S // 2,
                                               dtype=torch.int32)}}
    cfgs = _cfgs()
    # f32 frames, as tests/test_torch_vlm_audio.py's f32 runs take them
    inputs["frames"] = torch.tensor(np.random.default_rng(1).standard_normal(
        (B, cfgs["whisper-tiny"].encdec.source_len,
         cfgs["whisper-tiny"].d_model)) * 0.02, dtype=torch.float32)
    for name, cfg in cfgs.items():
        inputs[name] = build_model(cfg).init(
            torch.Generator().manual_seed(3), torch.float32)
    bs = [ts.next_batch() for _ in range(2)]
    inputs["batches"] = {k: torch.tensor(np.stack([x[k] for x in bs]))
                         for k in bs[0]}
    init = tmp_path_factory.mktemp("mesh4") / "init"
    res = spawn(4, _mesh4_rank, device="cpu", init_file=str(init),
                args=(inputs,), timeout_s=240)
    torch.set_num_threads(1)
    plain = {name: _runs(cfg, inputs[name], inputs)
             for name, cfg in cfgs.items()}
    return dict(res=res, plain=plain, inputs=inputs)


def test_fabric_all_to_all_matches_lax(ref, mesh4):
    for r, out in enumerate(mesh4["res"]):
        for k, got in out["a2a"].items():
            assert np.array_equal(got, ref["a2a"][k][r]), (r, k)
        # one all_to_all_single a call, its operand the whole block
        assert out["a2a_log"] == [("all_to_all", 4 * 8 * 12 * 4, 4)] * 4
    from repro_torch.analysis.traffic import all_to_all_bytes
    from repro_torch.comm.collectives import LoggedCall
    log = [LoggedCall("all_to_all", "float32", 384, False, None, None, 4)]
    assert all_to_all_bytes(log, 4) == 288
    assert mesh4["res"][0]["fabric_sizes"] == (2, 2, 4)


def _hold_partitioned(got, plain):
    """The loss within 1e-5, each gradient leaf within 1e-5 of its largest
    magnitude (floored at 1e-8: a key bias's gradient is 0 in exact
    arithmetic, the softmax ignoring a shift shared by every key, and
    both runs hold ~1e-10 there), the prefill's and a decode step's
    logits within 1e-5 of their largest."""
    assert abs(float(got["loss"]) - float(plain["loss"])) <= 1e-5
    assert len(got["grads"]) == len(plain["grads"])
    for i, (g, w) in enumerate(zip(got["grads"], plain["grads"])):
        tol = max(1e-5 * float(w.abs().max()), 1e-8)
        assert float((g - w).abs().max()) <= tol, i
    for k in ("prefill", "step"):
        w = plain[k]
        assert got[k].shape == w.shape
        tol = 1e-5 * float(w.abs().max())
        assert float((got[k] - w).abs().max()) <= tol, k


@pytest.mark.parametrize("name", ["reduced", "heads8"])
def test_partitioned_tinyllama_matches_unpartitioned(mesh4, name):
    """(2, 2) mesh, f32, against the unpartitioned port
    (:func:`_hold_partitioned`); every rank holds the same."""
    for out in mesh4["res"]:
        _hold_partitioned(out[name], mesh4["plain"][name])


@pytest.mark.parametrize("arch", FAMILIES)
def test_partitioned_family_matches_unpartitioned(mesh4, arch):
    """The DTensor branches of the other families (conv1d, SSD, RG-LRU,
    MLA, the MoE block and MTP head, whisper's attention, the tied
    vocab-parallel embedding) at ``.reduced()`` on the (2, 2) mesh in
    f32, against the unpartitioned port as tinyllama is held; a leaf a
    branch cut off the graph would show as a zero gradient here."""
    plain = mesh4["plain"][arch]
    for out in mesh4["res"]:
        _hold_partitioned(out[arch], plain)


def test_local_updates_payload_is_the_unsplit_exchange(mesh4):
    """One ``int8`` round of ``lower_train_local_updates`` on (2, 2), the
    params split over ``model``: every delta it encodes is a whole leaf;
    its gathered payload and mean are, bit for bit, what the
    unpartitioned exchange over the data group makes of the same deltas;
    the two data ranks stepped apart, each on its own rows; and its
    params are those of the unpartitioned ``local_updates_round`` over the
    data group within 1e-5 of each leaf's largest magnitude (the model
    axis splits the row-parallel products' sums, so the two rounds'
    deltas round apart)."""
    for out in mesh4["res"]:
        lu = out["lu"]
        assert lu["delta_numel"] == lu["leaf_numel"]
        for (m, g), (mr, gr) in zip(lu["part"], lu["replay"], strict=True):
            assert torch.equal(m, mr)
            assert len(g) == len(gr) == 2
            assert all(torch.equal(a, b) for a, b in zip(g, gr))
            # rows 0 and 1: the two data ranks' codes
            assert not torch.equal(g[0][0], g[0][1])
        for a, b in zip(lu["params_part"], lu["params_plain"], strict=True):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
        assert lu["placements_kept"]


# -- _moe_sharded on 8 ranks as (2, 4) -------------------------------------

def _moe_loss(y, wy):
    # the aux loss left out: the sharded block's is the data shards' mean
    # of their own (the reference's), not the global batch's
    return (y * wy).sum()


def _moe_rank(rank, world, device, params, x, wy):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.utils.trees import tree_leaves, tree_unflatten
    cfg = get_config("deepseek-v3-671b").reduced()
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    before = dict(L.MOE_PATHS)
    with build.partitioning(mesh):
        y, aux = L.moe_apply(params, cfg, x)
    ran = {k: L.MOE_PATHS[k] - before[k] for k in before}
    # gradients through the DTensor path, without drops
    dp = sh.distribute(params, sh.param_specs(params, mesh), mesh)
    live = [t.detach().requires_grad_(True) for t in tree_leaves(dp)]
    dx = sh.distribute(x, ("data", None, None), mesh).requires_grad_(True)
    with build.partitioning(mesh):
        yd, _ = L.moe_apply(tree_unflatten(dp, live), cfg, dx,
                            no_drop=True)
        loss = L.replicated(_moe_loss(yd, wy))
        grads = torch.autograd.grad(loss, live + [dx])
    # a batch of one row (the data axes do not divide it): the global
    # path on DTensors, each rank its experts, partial over the model axis
    before = dict(L.MOE_PATHS)
    with build.partitioning(mesh), torch.no_grad():
        y1, _ = L.moe_apply(dp, cfg, sh.distribute(x[:1], (None, None, None),
                                                   mesh))
    ran1 = {k: L.MOE_PATHS[k] - before[k] for k in before}
    return dict(y=y.detach(), aux=float(aux), ran=ran,
                coord=mesh.get_coordinate(),
                grads=[g.full_tensor() for g in grads],
                y_one_row=y1.full_tensor(), ran_one_row=ran1)


@pytest.fixture(scope="module")
def moe8(ref, tmp_path_factory):
    from repro_torch.utils.trees import tree_map
    from repro_torch.utils.trees import tree_leaves, tree_unflatten
    params = tree_map(torch.from_numpy, ref["moe"]["params"])
    x = torch.from_numpy(ref["moe"]["x"])
    wy = torch.randn(x.shape, generator=torch.Generator().manual_seed(5))
    init = tmp_path_factory.mktemp("moe8") / "init"
    res = spawn(8, _moe_rank, device="cpu", init_file=str(init),
                args=(params, x, wy), timeout_s=240)
    cfg = get_config("deepseek-v3-671b").reduced()
    set_partitioning(None, None)
    torch.set_num_threads(1)
    y_glob, _ = L.moe_apply(params, cfg, x)
    live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    xl = x.clone().requires_grad_(True)
    yg, _ = L.moe_apply(tree_unflatten(params, live), cfg, xl,
                        no_drop=True)
    grads = torch.autograd.grad(_moe_loss(yg, wy), live + [xl])
    y_one, _ = L.moe_apply(params, cfg, x[:1])
    return dict(res=res, y_global=y_glob, grads=grads, y_one_row=y_one)


def test_moe_sharded_matches_reference_and_global(ref, moe8):
    """Each rank's rows (its data shard) of the sharded block: within
    1e-5 of the reference's ``_moe_sharded`` (the same local drops) and
    of the global ``moe_apply``; the counter shows the sharded path."""
    want = ref["moe"]["y_sharded"]
    rows = want.shape[0] // 2
    for out in moe8["res"]:
        assert out["ran"] == {"global": 0, "sharded": 1}
        d = out["coord"][0]
        y = out["y"].numpy()
        assert y.shape == (rows, 16, want.shape[2])
        assert np.max(np.abs(y - want[d * rows:(d + 1) * rows])) <= 1e-5
        glob = moe8["y_global"][d * rows:(d + 1) * rows].numpy()
        assert np.max(np.abs(y - glob)) <= 1e-5
        assert math.isclose(out["aux"], ref["moe"]["aux_sharded"],
                            rel_tol=1e-5)


def test_moe_sharded_gradients_match_global(moe8):
    """The DTensor path's gradients of a weighted sum of the block's
    output (every param leaf and the input, without drops) within 1e-5
    of each leaf's largest magnitude of the global ``moe_apply``'s."""
    for out in moe8["res"]:
        for g, w in zip(out["grads"], moe8["grads"]):
            tol = 1e-5 * max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) <= tol


def test_moe_global_path_on_dtensors_matches_global(moe8):
    """B = 1 (the data axes do not divide it): the global path, each rank
    running its experts, within 1e-5 of the plain ``moe_apply``."""
    want = moe8["y_one_row"]
    for out in moe8["res"]:
        assert out["ran_one_row"] == {"global": 1, "sharded": 0}
        tol = 1e-5 * float(want.abs().max())
        assert float((out["y_one_row"] - want).abs().max()) <= tol

