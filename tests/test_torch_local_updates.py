"""The port's optimizer, token stream, local-update rounds and checkpoint
against the reference on the CPU.

One subprocess runs the reference over 4 faked host devices (the pattern
of ``tests/test_distributed.py``): ``local_updates_round`` under
``shard_map`` for one K = 4 round (H = 2) of the reduced tinyllama in
f32 under ``f32``, ``int8``, ``ef:int4`` and ``topk(r=0.125)``; and its
``_codec_mean`` alone, jitted under ``shard_map``, on the deltas its own
shards' local steps produced; and H steps of its
``make_train_step(grad_sync_axis="data")``, shard k on its own batches.
The port's ``virtual_round`` runs the same
round on the carried params and the same batches, and its
``exchange_leaf`` takes the same deltas.

Tolerances. The exchange alone is bit-identical (mean and ``ef:``
residual) for ``int8``, ``int2``, ``topk(r=0.125)`` and
``ef:topk(r=0.125)``; for ``int4`` and ``ef:int4`` the 1-ulp scale
caveat of ROADMAP.md holds (under ``jit`` XLA rewrites ``absmax / 7.5``
as a multiply by the reciprocal; the port holds the eager quotient):
within 2^-20 of the largest |input|, but for the few elements (under
0.1%) whose code that ulp moves across a rounding edge, which move by
one code step in the residual and one shard's share of it in the mean.
The whole round's params agree within 5e-7 under ``f32`` (f32 sum
orders; the deltas are ~3e-5), and under a lossy codec within one
shard's share of a code step or of a kept value (a grad that differs in
its last bits can move a code across a rounding edge, or a value across
the top-k threshold): 5e-7 (int8), 2e-6 (int4) and 1e-5 (topk), with
such elements under 0.5% of a leaf; an ``ef:`` residual within a whole
code step (K times that).

One spawned group of 4 gloo ranks (one CPU thread each, ``file://``
init) runs ``local_updates_round`` with the group's ``Fabric`` as its
``axis_name``, on the same carried params and batches, rank k shard k:
against the reference's round at the tolerances above, and against
``virtual_round`` (run here with one thread too). The codec paths are
bit for bit: a rank's ``(1, L)`` row is encoded as row k of the
virtual stack and the gathered rows decoded in worker order, as there.
The ``f32`` mean and the opt-state sync add in gloo's order: within
5e-7 (params) and rtol 1e-6 plus 1e-6 of a leaf's largest |value|
(mu/nu) at K = 4, and bit for bit at K = 2 (a two-rank subgroup), where
a sum of two does not depend on order. The same group runs the
reference's H = 1 and codec toy rounds (``tests/test_distributed.py``)
and ``make_train_step(grad_sync_axis=...)``, held to the reference's
grad-synced steps at the ``f32`` round's tolerances. The delta exchange and the
opt-state sync are recorded apart (the sync's calls into a recording of
their own), every round.
"""
import hashlib
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as ref_restore
from repro.checkpoint import save_checkpoint as ref_save
from repro.configs import get_config as ref_get_config
from repro.data.tokens import TokenStream as RefTokenStream
from repro.models import build_model as ref_build_model
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import local_updates as ref_lu
from repro.train import make_train_step as ref_make_train_step
from repro.utils import trees as ref_trees
from repro_torch.analysis.traffic import (derived_round_traffic,
                                          payload_collectives,
                                          quantized_wire_dtypes)
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.comm.collectives import CollectiveLog, Fabric, recording
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.models import build_model
from repro_torch.models.carry import params_from_reference, params_to_reference
from repro_torch.optim import (AdamWConfig, LocalUpdatesConfig, adamw_init,
                               adamw_update, cosine_schedule,
                               delta_wire_bytes, exchange_leaf,
                               init_delta_codec_state, local_updates_round,
                               suggest_H, virtual_round)
from repro_torch.comm import get_codec
from repro_torch.launch.dist import spawn
from repro_torch.optim import local_updates
from repro_torch.train import make_train_step
from repro_torch.train.loss import lm_loss
from repro_torch.utils.trees import (tree_allfinite, tree_bytes,
                                     tree_flatten_with_path, tree_leaves,
                                     tree_map, tree_params, tree_unflatten)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "tinyllama-1.1b"
K, H, B, S = 4, 2, 2, 32
ROUND_CODECS = {"f32": 5e-7, "int8": 5e-7, "ef:int4": 2e-6,
                "topk(r=0.125)": 1e-5}
EXACT = ("int8", "int2", "topk(r=0.125)", "ef:topk(r=0.125)")
ULP_CAVEAT = ("int4", "ef:int4")
CODEC_NAMES = ("f32", "int8", "int4", "int2", "topk(r=0.125)",
               "ef:int4", "ef:int2", "ef:topk(r=0.125)")
# the codecs the 4-rank group runs; all but f32 are held to virtual_round
# bit for bit, K2 the two-rank subgroup's
DIST_CODECS = ("f32", "int8", "int2", "ef:int4", "topk(r=0.125)",
               "ef:topk(r=0.125)")
LOSSY = DIST_CODECS[1:]
K2_CODECS = ("f32", "int8")
# the MoE arch of one more round (int8): the loss and its terms a step
MOE_ARCH = "deepseek-v3-671b"
TERMS = ("loss", "aux_loss", "mtp_loss")
WIRE = {"f32": set(), "int8": {"int8"}, "int2": {"uint8"},
        "ef:int4": {"uint8"}, "topk(r=0.125)": set(),
        "ef:topk(r=0.125)": set()}

REFERENCE = f"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.comm import get_codec
from repro.configs import get_config
from repro.data.tokens import TokenStream
from repro.models import build_model
from repro.optim import AdamWConfig, adamw_init
from repro.optim.local_updates import (LocalUpdatesConfig, _codec_mean,
                                       init_delta_codec_state,
                                       local_updates_round)
from repro.train import make_train_step
from repro.utils.compat import make_mesh, shard_map

K, H, B, S = {K}, {H}, {B}, {S}
cfg = get_config({ARCH!r}).reduced()
model = build_model(cfg)
params = jax.jit(lambda k: model.init(k, jnp.float32))(jax.random.key(0))
opt_cfg = AdamWConfig(lr=1e-3)
opt = adamw_init(params, opt_cfg)
ts = TokenStream(cfg.vocab_size, S, B, seed=0)
bs = [ts.next_batch() for _ in range(K * H)]
batches = {{n: jnp.asarray(np.stack([b[n] for b in bs]).reshape(K, H, B, S))
           for n in ("tokens", "labels")}}
step = make_train_step(model, opt_cfg)
mesh = make_mesh((K,), ("data",))
out = {{}}

def put(tree, pre):
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        out[f"{{pre}}/{{i}}"] = np.asarray(leaf)

for codec in {list(ROUND_CODECS)!r}:
    lc = LocalUpdatesConfig(H=H, codec=codec)
    cs = init_delta_codec_state(params, lc)
    if cs is None:
        def run(p, o, b):
            pH, oH, m = local_updates_round(
                step, p, o, jax.tree.map(lambda x: x[0], b), lc, "data")
            return pH, oH, m["loss"][None]
        f = shard_map(run, mesh, in_specs=(P(), P(), P("data")),
                      out_specs=(P(), P(), P("data")))
        pH, oH, loss = jax.jit(f)(params, opt, batches)
    else:
        def run(p, o, b, c):
            pH, oH, m, c = local_updates_round(
                step, p, o, jax.tree.map(lambda x: x[0], b), lc, "data",
                codec_state=jax.tree.map(lambda x: x[0], c))
            return pH, oH, m["loss"][None], jax.tree.map(lambda x: x[None], c)
        f = shard_map(run, mesh, in_specs=(P(), P(), P("data"), P("data")),
                      out_specs=(P(), P(), P("data"), P("data")))
        csK = jax.tree.map(lambda s: jnp.stack([s] * K), cs)
        pH, oH, loss, c = jax.jit(f)(params, opt, batches, csK)
        put(c, codec + "/state")
    put(pH, codec + "/params")
    put(oH["mu"], codec + "/mu")
    put(oH["nu"], codec + "/nu")
    out[codec + "/loss"] = np.asarray(loss)

# the exchange alone, on the deltas of the reference's own shards
def local(p, o, b):
    pH, _, _ = local_updates_round(step, p, o,
                                   jax.tree.map(lambda x: x[0], b),
                                   LocalUpdatesConfig(H=H), None)
    return jax.tree.map(lambda a, b0: (a.astype(jnp.float32)
                                       - b0.astype(jnp.float32))[None],
                        pH, p)

deltas = jax.jit(shard_map(local, mesh, in_specs=(P(), P(), P("data")),
                           out_specs=P("data")))(params, opt, batches)
deltas = jax.tree.map(lambda d: d.reshape(K, -1), deltas)
put(deltas, "delta")
rng = np.random.default_rng(0)
resid = jax.tree.map(lambda d: jnp.asarray(
    rng.standard_normal(d.shape) * 1e-6, jnp.float32), deltas)
put(resid, "resid")
for codec in {list(EXACT + ULP_CAVEAT)!r}:
    c = get_codec(codec)
    if c.stateful:
        def g(ds, rs):
            dl, td = jax.tree.flatten(ds)
            out_ = [_codec_mean(d[0], c, "data", r[0])
                    for d, r in zip(dl, jax.tree.leaves(rs))]
            return ([m for m, _ in out_], [s[None] for _, s in out_])
        f = shard_map(g, mesh, in_specs=(P("data"), P("data")),
                      out_specs=(P(), P("data")))
        means, states = jax.jit(f)(deltas, resid)
        put(states, codec + "/exchange_state")
    else:
        f = shard_map(lambda ds: [_codec_mean(d[0], c, "data")
                                  for d in jax.tree.leaves(ds)],
                      mesh, in_specs=P("data"), out_specs=P())
        means = jax.jit(f)(deltas)
    put(means, codec + "/exchange")

# synchronous data parallelism: H steps of the grad-synced step, shard k
# on its own H batches
synced = make_train_step(model, opt_cfg, grad_sync_axis="data")
def dp(p, o, b):
    b = jax.tree.map(lambda x: x[0], b)
    for h in range(H):
        p, o, _ = synced(p, o, jax.tree.map(lambda x: x[h], b))
    return p, o
pS, oS = jax.jit(shard_map(dp, mesh, in_specs=(P(), P(), P("data")),
                           out_specs=(P(), P())))(params, opt, batches)
put(pS, "grad_sync/params")
put(oS["mu"], "grad_sync/mu")
put(oS["nu"], "grad_sync/nu")

# deepseek-v3 at .reduced() (MoE, MLA, the MTP head): one int8 round on
# the same batches, its loss, aux and MTP terms a step
dmodel = build_model(get_config({MOE_ARCH!r}).reduced())
dparams = jax.jit(lambda k: dmodel.init(k, jnp.float32))(jax.random.key(0))
dstep = make_train_step(dmodel, opt_cfg)
dlc = LocalUpdatesConfig(H=H, codec="int8")
def drun(p, o, b):
    pH, oH, m = local_updates_round(
        dstep, p, o, jax.tree.map(lambda x: x[0], b), dlc, "data")
    return pH, oH, jnp.stack([m[n] for n in {list(TERMS)!r}])[None]
f = shard_map(drun, mesh, in_specs=(P(), P(), P("data")),
              out_specs=(P(), P(), P("data")))
pH, oH, terms = jax.jit(f)(dparams, adamw_init(dparams, opt_cfg), batches)
put(pH, "deepseek/params")
put(oH["mu"], "deepseek/mu")
put(oH["nu"], "deepseek/nu")
out["deepseek/terms"] = np.asarray(terms)
np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reduced():
    rcfg = ref_get_config(ARCH).reduced()
    rm = ref_build_model(rcfg)
    ref = jax.device_get(jax.jit(lambda k: rm.init(k, jnp.float32))(
        jax.random.key(0)))
    cfg = get_config(ARCH).reduced()
    return dict(rm=rm, ref=ref, cfg=cfg, m=build_model(cfg),
                params=params_from_reference(ref, cfg, device="cpu"))


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The reference's round and exchange on 4 faked devices."""
    path = str(tmp_path_factory.mktemp("lu") / "ref.npz")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REFERENCE, path],
                         capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(path))


def _batches():
    ts = TokenStream(512, S, B, seed=0)
    bs = [ts.next_batch() for _ in range(K * H)]
    return {n: torch.tensor(np.stack([b[n] for b in bs]).reshape(K, H, B, S))
            for n in ("tokens", "labels")}


def _leaves(ref, pre):
    n = sum(1 for k in ref if k.startswith(pre + "/"))
    return [ref[f"{pre}/{i}"] for i in range(n)]


# -- optimizer, schedule, data --------------------------------------------

def _opt_tree(seed):
    """A matrix, a stacked norm scale (2-D, decayed by the reference's
    ``p.ndim`` rule) and a final norm scale (1-D, not decayed)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "stack_norm": (1 + 0.1 * rng.standard_normal((2, 5))).astype(
                np.float32),
            "final_norm": (1 + 0.1 * rng.standard_normal(5)).astype(
                np.float32)}


@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_update_matches_reference(clip):
    cfg, rcfg = AdamWConfig(lr=1e-2, grad_clip=clip), RefAdamWConfig(
        lr=1e-2, grad_clip=clip)
    p, tp = _opt_tree(0), tree_map(torch.tensor, _opt_tree(0))
    st, rst = adamw_init(tp, cfg), ref_adamw_init(p, rcfg)
    for t in range(3):
        g = _opt_tree(10 + t)
        lr_scale = 0.5 + 0.1 * t
        tp, st, m = adamw_update(tp, tree_map(torch.tensor, g), st, cfg,
                                 torch.tensor(lr_scale, dtype=torch.float32))
        p, rst, rm = ref_adamw_update(p, g, rst, rcfg, jnp.float32(lr_scale))
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        for name in p:
            for a, b in ((tp[name], p[name]), (st["mu"][name],
                                               rst["mu"][name]),
                         (st["nu"][name], rst["nu"][name])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-7)
    assert int(st["count"]) == int(rst["count"]) == 3


def test_weight_decay_follows_ndim_as_the_reference():
    """With zero grads only the decay moves a param: the stacked norm
    scale (2-D) decays, the final norm scale (1-D) does not."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5)
    p = tree_map(torch.tensor, _opt_tree(1))
    zeros = tree_map(torch.zeros_like, p)
    new, _, _ = adamw_update(p, zeros, adamw_init(p, cfg), cfg)
    ref, _, _ = ref_adamw_update(_opt_tree(1), tree_map(np.zeros_like,
                                                        _opt_tree(1)),
                                 ref_adamw_init(_opt_tree(1), RefAdamWConfig(
                                     lr=0.1, weight_decay=0.5)),
                                 RefAdamWConfig(lr=0.1, weight_decay=0.5))
    assert torch.equal(new["final_norm"], p["final_norm"])
    np.testing.assert_allclose(new["stack_norm"].numpy(),
                               p["stack_norm"].numpy() * (1 - 0.1 * 0.5),
                               rtol=1e-6)
    for name in new:
        np.testing.assert_allclose(new[name].numpy(), np.asarray(ref[name]),
                                   rtol=1e-6)


def test_cosine_schedule_matches_reference():
    steps = np.array([0, 1, 2, 50, 99, 100, 101, 5000, 9999, 10000, 12000])
    for kw in ({}, dict(warmup=2, total=6, min_frac=0.1),
               dict(warmup=0, total=1)):
        got = cosine_schedule(torch.tensor(steps), **kw).numpy()
        want = np.asarray(ref_cosine(jnp.asarray(steps), **kw))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_token_stream_is_bit_identical():
    a = TokenStream(32000, 64, 3, seed=5)
    b = RefTokenStream(32000, 64, 3, seed=5)
    for _ in range(3):
        x, y = a.next_batch(), b.next_batch()
        for k in ("tokens", "labels"):
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


def test_suggest_H_matches_reference():
    for tc in (1e-3, 1.0):
        for tx in (0.0, 1e-4, 0.5, 3.0, 100.0):
            for cap in (1, 48, 64):
                assert suggest_H(tc, tx, max_H=cap) == ref_lu.suggest_H(
                    tc, tx, max_H=cap)


# -- config, byte model -----------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(codec="ef:f32"), dict(codec="ef:ef:int8"), dict(codec="topk(r=0)"),
    dict(codec="topk(r=2)"), dict(codec="topk(x)"), dict(codec="bogus"),
    dict(codec="int8", average="params"),
    dict(codec="ef:topk", average="params")])
def test_local_updates_config_refusals_equal_the_reference(kw):
    with pytest.raises(Exception) as ref_err:
        ref_lu.LocalUpdatesConfig(**kw)
    with pytest.raises(Exception) as err:
        LocalUpdatesConfig(**kw)
    assert type(err.value) is type(ref_err.value)
    assert str(err.value) == str(ref_err.value)


@pytest.mark.parametrize("codec", CODEC_NAMES)
def test_delta_wire_bytes_equal_on_the_reduced_and_full_trees(reduced,
                                                              codec):
    ref_cfg, cfg = ref_lu.LocalUpdatesConfig(codec=codec), \
        LocalUpdatesConfig(codec=codec)
    with torch.device("meta"):
        full = build_model(get_config(ARCH)).init(None)
    full_ref = jax.eval_shape(ref_build_model(ref_get_config(ARCH)).init,
                              jax.random.key(0))
    for k in (1, 4, 8):
        assert delta_wire_bytes(reduced["params"], cfg, k) == \
            ref_lu.delta_wire_bytes(reduced["ref"], ref_cfg, k)
        assert delta_wire_bytes(full, cfg, k) == \
            ref_lu.delta_wire_bytes(full_ref, ref_cfg, k)


@pytest.mark.parametrize("poison", [None, float("nan"), float("inf")])
def test_tree_helpers_match_the_reference(poison):
    """``tree_bytes``, ``tree_params`` and ``tree_allfinite`` on the same
    tree of f32, bf16 and int32 leaves (one element poisoned or not),
    and the first two on the full tinyllama's shapes alone."""
    rng = np.random.default_rng(3)
    ref = {"b": [rng.standard_normal(5).astype(np.float32),
                 rng.integers(0, 9, (2,)).astype(np.int32)],
           "a": rng.standard_normal((3, 4)).astype(np.float32),
           "c": {"d": rng.standard_normal((2, 2)).astype(np.float32)}}
    if poison is not None:
        ref["c"]["d"][1, 0] = poison
    ref["b"][0] = jnp.asarray(ref["b"][0], jnp.bfloat16)
    port = tree_map(lambda x: torch.from_numpy(np.asarray(x, np.float32)
                                               if x.dtype == jnp.bfloat16
                                               else np.asarray(x)), ref)
    port["b"][0] = port["b"][0].to(torch.bfloat16)
    assert tree_bytes(port) == ref_trees.tree_bytes(ref) == 82
    assert tree_params(port) == ref_trees.tree_params(ref) == 23
    assert bool(tree_allfinite(port)) == bool(ref_trees.tree_allfinite(ref)) \
        == (poison is None)
    with torch.device("meta"):
        full = build_model(get_config(ARCH)).init(None)
    full_ref = jax.eval_shape(ref_build_model(ref_get_config(ARCH)).init,
                              jax.random.key(0))
    assert tree_bytes(full) == ref_trees.tree_bytes(full_ref)
    assert tree_params(full) == ref_trees.tree_params(full_ref)


def test_codec_state_shapes(reduced):
    cfg = LocalUpdatesConfig(codec="ef:int4")
    one = init_delta_codec_state(reduced["params"], cfg)
    ref = ref_lu.init_delta_codec_state(reduced["ref"], ref_lu.
                                        LocalUpdatesConfig(codec="ef:int4"))
    assert [tuple(x.shape) for x in tree_leaves(one)] == [
        x.shape for x in jax.tree.leaves(ref)]
    stack = init_delta_codec_state(reduced["params"], cfg, shards=K)
    assert [tuple(x.shape) for x in tree_leaves(stack)] == [
        (K,) + x.shape for x in jax.tree.leaves(ref)]
    assert init_delta_codec_state(reduced["params"],
                                  LocalUpdatesConfig(codec="int8")) is None


# -- rounds -----------------------------------------------------------------

def test_one_shard_round_matches_reference(reduced):
    """No data axis (the launcher's path): H steps, nothing exchanged."""
    rm, ref = reduced["rm"], reduced["ref"]
    bt = _batches()
    rstep = ref_make_train_step(rm, RefAdamWConfig(lr=1e-3))
    r_p, r_o, r_m = jax.jit(lambda p, o, b: ref_lu.local_updates_round(
        rstep, p, o, b, ref_lu.LocalUpdatesConfig(H=H), None))(
        ref, ref_adamw_init(ref, RefAdamWConfig(lr=1e-3)),
        {k: jnp.asarray(v[0].numpy()) for k, v in bt.items()})
    step = make_train_step(reduced["m"], AdamWConfig(lr=1e-3))
    cfg = LocalUpdatesConfig(H=H, codec="ef:int4")
    state = init_delta_codec_state(reduced["params"], cfg)
    p, o, m, st = local_updates_round(
        step, reduced["params"], adamw_init(reduced["params"],
                                            AdamWConfig(lr=1e-3)),
        {k: v[0] for k, v in bt.items()}, cfg, codec_state=state)
    assert st is state
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(r_m["loss"]),
                               rtol=1e-5)
    for a, b in zip(tree_leaves(p), jax.tree.leaves(r_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=5e-7)


def test_microbatched_step_matches_reference(reduced):
    rm, ref = reduced["rm"], reduced["ref"]
    b = TokenStream(512, S, 4, seed=3).next_batch()
    rstep = jax.jit(ref_make_train_step(rm, RefAdamWConfig(lr=1e-3),
                                        microbatch=2))
    r_p, _, r_m = rstep(ref, ref_adamw_init(ref, RefAdamWConfig(lr=1e-3)),
                        b)
    step = make_train_step(reduced["m"], AdamWConfig(lr=1e-3), microbatch=2)
    p, _, m = step(reduced["params"], adamw_init(reduced["params"],
                                                 AdamWConfig(lr=1e-3)),
                   {k: torch.tensor(v) for k, v in b.items()})
    for k in ("loss", "ce", "accuracy", "grad_norm", "lr_scale"):
        np.testing.assert_allclose(float(m[k]), float(r_m[k]), rtol=1e-5)
    for a, r in zip(tree_leaves(p), jax.tree.leaves(r_p)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=5e-7)


def _hold_round(out, sharded, pre, atol, opt_atol=1e-6):
    """``virtual_round``'s params and opt state against the reference's
    round under ``pre``: params within ``atol`` (elements past 2e-7
    under 0.5% of a leaf), mu and nu at rtol 1e-4 (atol ``opt_atol`` of
    the leaf's largest), the step count H."""
    ref_p = _leaves(sharded, pre + "/params")
    assert len(ref_p) == len(tree_leaves(out[0]))
    for (key, a), b in zip(tree_flatten_with_path(out[0]), ref_p):
        a = a.numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=key)
        assert np.mean(np.abs(a - b) > 2e-7) < 5e-3, key
    for name in ("mu", "nu"):
        for (key, a), b in zip(tree_flatten_with_path(out[1][name]),
                               _leaves(sharded, f"{pre}/{name}")):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                       atol=opt_atol * np.abs(b).max(),
                                       err_msg=f"{name} {key}")
    assert int(out[1]["count"]) == H


@pytest.mark.parametrize("codec", list(ROUND_CODECS))
def test_virtual_round_matches_the_sharded_reference(reduced, sharded,
                                                     codec):
    """One K = 4 round (H = 2) on one device against the reference's
    ``shard_map`` round on 4 faked devices; tolerances in the module
    docstring."""
    cfg = LocalUpdatesConfig(H=H, codec=codec)
    step = make_train_step(reduced["m"], AdamWConfig(lr=1e-3))
    params = reduced["params"]
    state = init_delta_codec_state(params, cfg, shards=K)
    out = virtual_round(step, params, adamw_init(params, AdamWConfig(
        lr=1e-3)), _batches(), cfg, state)
    np.testing.assert_allclose(out[2]["loss"].numpy(),
                               sharded[codec + "/loss"], rtol=1e-5)
    assert out[2]["wire_bytes"] == delta_wire_bytes(params, cfg, K)
    atol = ROUND_CODECS[codec]
    _hold_round(out, sharded, codec, atol)
    if state is not None:
        for a, b in zip(tree_leaves(out[3]),
                        _leaves(sharded, codec + "/state")):
            # where a code flips, the shard's residual moves by a whole
            # code step, K times its share of the mean
            np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=K * atol)
            assert np.mean(np.abs(a.numpy() - b) > 2e-7) < 5e-3


def test_moe_round_matches_the_sharded_reference(sharded):
    """deepseek-v3 at ``.reduced()`` in f32 (the router, the capacity
    dispatch, MLA and the MTP head), one K = 4 ``int8`` round (H = 2)
    against the reference's ``shard_map`` round on the same params and
    batches: the loss and its aux and MTP terms a step, the wire bytes,
    params at the ``int8`` tolerance above, the opt state at the MoE
    family's gradient tolerance."""
    rm = ref_build_model(ref_get_config(MOE_ARCH).reduced())
    ref = jax.device_get(jax.jit(lambda k: rm.init(k, jnp.float32))(
        jax.random.key(0)))
    cfg = get_config(MOE_ARCH).reduced()
    params = params_from_reference(ref, cfg, device="cpu")
    lc = LocalUpdatesConfig(H=H, codec="int8")
    step = make_train_step(build_model(cfg), AdamWConfig(lr=1e-3))
    out = virtual_round(step, params, adamw_init(params, AdamWConfig(
        lr=1e-3)), _batches(), lc)
    terms = np.stack([out[2][n].numpy() for n in TERMS], 1)
    assert terms.shape == (K, len(TERMS), H)
    np.testing.assert_allclose(terms, sharded["deepseek/terms"], rtol=1e-5)
    assert (terms[:, 1:] > 0).all()
    assert out[2]["wire_bytes"] == delta_wire_bytes(params, lc, K)
    # the opt state at the MoE family's gradient tolerance, atol 1e-5 of a
    # leaf's largest (tests/test_torch_moe_mla.py): a mu element that sums
    # two steps' grads to ~5e-10 keeps their f32 rounding, ~3e-11
    _hold_round(out, sharded, "deepseek", ROUND_CODECS["int8"],
                opt_atol=1e-5)


@pytest.mark.parametrize("codec", EXACT + ULP_CAVEAT)
def test_exchange_alone_equals_the_reference_codec_mean(sharded, codec):
    """``exchange_leaf`` on the reference's own deltas (and, under
    ``ef:``, a residual) against ``_codec_mean`` jitted under
    ``shard_map``: bit for bit, but for the int4 scale caveat."""
    c = get_codec(codec)
    deltas = _leaves(sharded, "delta")
    means = _leaves(sharded, codec + "/exchange")
    states = (_leaves(sharded, codec + "/exchange_state") if c.stateful
              else [None] * len(deltas))
    resid = _leaves(sharded, "resid")
    for i, (d, want) in enumerate(zip(deltas, means)):
        got, st, _ = exchange_leaf(
            c, torch.tensor(d), torch.tensor(resid[i]) if c.stateful
            else None)
        pairs = [(got.numpy(), want)]
        if c.stateful:
            pairs.append((st.numpy(), states[i]))
        for a, b in pairs:
            if codec in EXACT:
                assert np.array_equal(a.view(np.int32), b.view(np.int32)), i
                continue
            # one ulp of the scale moves a value by 2^-20 of the largest
            # |input| at most, and can move a code across a rounding
            # edge: that element moves by a code step (the scale) in the
            # residual, by a shard's share of it in the mean
            x = d + resid[i] if c.stateful else d
            step = np.abs(x).max(axis=1).max() / 7.5
            fine = 2.0 ** -20 * np.abs(x).max()
            share = step if a is not pairs[0][0] else step / K
            np.testing.assert_allclose(a, b, rtol=0, atol=share + fine)
            assert np.mean(np.abs(a - b) > fine) < 1e-3, i


def test_virtual_round_without_opt_sync_and_by_params(reduced):
    """``sync_opt_state=False`` keeps each shard's opt state; averaging
    the params instead of the deltas gives the same params in f32."""
    step = make_train_step(reduced["m"], AdamWConfig(lr=1e-3))
    params = reduced["params"]
    opt = adamw_init(params, AdamWConfig(lr=1e-3))
    bt = _batches()
    p1, opts, _ = virtual_round(step, params, opt, bt, LocalUpdatesConfig(
        H=H, sync_opt_state=False))
    assert isinstance(opts, list) and len(opts) == K
    p2, o2, _ = virtual_round(step, params, opt, bt, LocalUpdatesConfig(
        H=H, average="params"))
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-7)
    mean_mu = [sum(tree_leaves(o["mu"])[i] for o in opts) / K
               for i in range(len(tree_leaves(params)))]
    for a, b in zip(mean_mu, tree_leaves(o2["mu"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-9)
    with pytest.raises(ValueError, match="opt states"):
        virtual_round(step, params, opts[:2], bt, LocalUpdatesConfig(H=H))


def _sgd(lr):
    """The reference test's plain SGD step on ``mean((x @ w - y)^2)``,
    batches the tuple ``(x, y)``."""
    def step(w, o, b):
        x, y = b
        live = w.detach().requires_grad_(True)
        g, = torch.autograd.grad(torch.mean((x @ live - y) ** 2), live)
        return w - lr * g, o, {}
    return step


def test_a_tuple_batch_gives_what_the_same_data_in_a_dict_gives():
    """``local_updates_round`` scans the leading axis of any tree of
    batches, as the reference's ``lax.scan`` does."""
    rng = np.random.default_rng(1)
    X = torch.tensor(rng.standard_normal((3, 6, 4)), dtype=torch.float32)
    Y = torch.tensor(rng.standard_normal((3, 6)), dtype=torch.float32)
    w0 = torch.tensor(rng.standard_normal(4), dtype=torch.float32)
    cfg = LocalUpdatesConfig(H=3)
    by_tuple, _, _ = local_updates_round(_sgd(0.1), w0, {}, (X, Y), cfg)
    sgd = _sgd(0.1)
    by_dict, _, _ = local_updates_round(
        lambda w, o, b: sgd(w, o, (b["x"], b["y"])), w0, {},
        {"x": X, "y": Y}, cfg)
    assert not torch.equal(by_tuple, w0)
    assert torch.equal(by_tuple, by_dict)


def _hash(tree) -> str:
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _grads(model, params, batch):
    """The step's gradients of ``batch``'s loss at ``params`` (no sync)."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = lm_loss(model, tree_unflatten(params, live), batch)
    return list(torch.autograd.grad(loss, live))


def _toy_data():
    """The reference tests' toy problems: (X, Y) of the H = 1 test, and
    (X, Y, w0) of the codec test."""
    rng = np.random.default_rng(0)
    rng.standard_normal((8, 4, 3))            # the reference's dead draw
    def f32(shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)

    sync = (f32((4, 1, 6, 3)), f32((4, 1, 6)))
    rng = np.random.default_rng(0)
    codec = (f32((4, 2, 6, 3)), f32((4, 2, 6)), f32(3))
    return sync, codec


def _lu_rank(rank, world, device, params, batches):
    """Rank ``rank`` (shard ``rank``) of the 4-rank group: every round the
    tests read. Rank 0 returns the params and opt states; every rank its
    params' hash, its residuals and its recorded calls, the delta
    exchange's and the opt-state sync's apart."""
    import torch.distributed as tdist
    fab = Fabric()
    pair = tdist.new_group([0, 1])          # every rank takes part
    model = build_model(get_config(ARCH).reduced())
    opt_cfg = AdamWConfig(lr=1e-3)
    step = make_train_step(model, opt_cfg)
    mine = {n: v[rank] for n, v in batches.items()}
    sync, opt_logs = local_updates._sync_opt_state, []

    def sync_recorded(o, f):
        with recording() as log:
            out = sync(o, f)
        opt_logs.append(list(log))
        return out

    local_updates._sync_opt_state = sync_recorded

    def rounds(codec, n, fabric=fab, full=rank == 0, **kw):
        cfg = LocalUpdatesConfig(H=H, codec=codec, **kw)
        p, o = params, adamw_init(params, opt_cfg)
        st = init_delta_codec_state(params, cfg)
        outs = []
        for t in range(1, n + 1):
            fabric.round = t
            opt_logs.clear()
            with recording() as log:
                out = local_updates_round(step, p, o, mine, cfg, fabric, st)
            p, o, m = out[:3]
            st = out[3] if st is not None else None
            outs.append(dict(
                hash=_hash(p), state=st, wire=m["wire_bytes"],
                loss=m["loss"], delta_log=list(log),
                opt_log=opt_logs[0] if opt_logs else None,
                **(dict(params=p, mu=o["mu"], nu=o["nu"],
                        count=int(o["count"])) if full else {})))
        return outs

    out = {"one": {c: rounds(c, 1) for c in DIST_CODECS},
           "two": {c: rounds(c, 2, sync_opt_state=False)
                   for c in DIST_CODECS},
           "by_params": rounds("f32", 1, average="params")}
    if rank < 2:
        out["pair"] = {c: rounds(c, 1, fabric=Fabric(pair)) for c in K2_CODECS}
    # the reference's toy rounds: H = 1 SGD (tuple batches), the codecs
    (Xs, Ys), (Xc, Yc, w0) = _toy_data()
    out["h1"] = local_updates_round(_sgd(0.1), torch.zeros(3), {},
                                    (Xs[rank], Ys[rank]),
                                    LocalUpdatesConfig(H=1), fab)[0]
    out["toy"] = {(c, lr): local_updates_round(
        _sgd(lr), w0, {}, (Xc[rank], Yc[rank]),
        LocalUpdatesConfig(H=2, codec=c), fab)[0]
        for c, lr in [(c, 0.05) for c in ("f32", "int8", "int4", "int2")]
        + [(c, 0.0) for c in ("f32", "int8", "int4", "int2",
                              "topk(r=0.25)", "ef:int4")]}
    # synchronous data parallelism: two steps with the grads averaged
    # over the group's Fabric, and over the pair's process group
    p, o = params, adamw_init(params, opt_cfg)
    synced = make_train_step(model, opt_cfg, grad_sync_axis=fab)
    for h in range(H):
        p, o, _ = synced(p, o, {n: v[h] for n, v in mine.items()})
    out["grad_sync"] = _hash(p)
    if rank == 0:
        out["grad_sync_state"] = dict(params=p, mu=o["mu"], nu=o["nu"])
    if rank < 2:
        p2, o2 = params, adamw_init(params, opt_cfg)
        synced = make_train_step(model, opt_cfg, grad_sync_axis=pair)
        for h in range(H):
            p2, o2, _ = synced(p2, o2, {n: v[h] for n, v in mine.items()})
        out["pair_grad_sync"] = _hash(p2)
    if rank == 0:
        # one process: AdamW on (g0 + g1) / 2
        p, o = params, adamw_init(params, opt_cfg)
        for h in range(H):
            g0, g1 = (_grads(model, p, {n: v[k, h] for n, v in
                                        batches.items()}) for k in (0, 1))
            g = [(a + b) / torch.full_like(a, 2.0) for a, b in zip(g0, g1)]
            p, o, _ = adamw_update(p, tree_unflatten(p, g), o, opt_cfg,
                                   cosine_schedule(o["count"] + 1))
        out["pair_grad_sync_one_process"] = _hash(p)
    return out


@pytest.fixture(scope="module")
def dist(reduced, tmp_path_factory):
    init = tmp_path_factory.mktemp("lu_dist") / "init"
    return spawn(K, _lu_rank, device="cpu", init_file=str(init),
                 args=(reduced["params"], _batches()), timeout_s=240)


@pytest.fixture(scope="module")
def dist_virtual(reduced):
    """``virtual_round`` on the group's batches with one thread, as each
    rank runs: two rounds without the opt-state sync a lossy codec (the
    params and residuals after each), one ``f32`` round with it, and one
    round at K = 2 (shards 0 and 1) a codec of ``K2_CODECS``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params, bt = reduced["params"], _batches()
        step = make_train_step(reduced["m"], AdamWConfig(lr=1e-3))
        opt = adamw_init(params, AdamWConfig(lr=1e-3))
        out = {}
        for c in LOSSY:
            cfg = LocalUpdatesConfig(H=H, codec=c, sync_opt_state=False)
            p, o = params, opt
            st = init_delta_codec_state(params, cfg, shards=K)
            out[c] = []
            for _ in range(2):
                res = virtual_round(step, p, o, bt, cfg, st)
                p, o = res[:2]
                st = res[3] if st is not None else None
                out[c].append(dict(params=p, state=st))
        out["f32"] = virtual_round(step, params, opt, bt,
                                   LocalUpdatesConfig(H=H))
        for c in K2_CODECS:
            out["pair", c] = virtual_round(
                step, params, opt, {n: v[:2] for n, v in bt.items()},
                LocalUpdatesConfig(H=H, codec=c))
        return out
    finally:
        torch.set_num_threads(threads)


def _equal(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x.view(torch.int32),
                                                  y.view(torch.int32))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


@pytest.mark.parametrize("codec", list(ROUND_CODECS))
def test_rounds_across_ranks_match_the_sharded_reference(sharded, dist,
                                                         codec):
    """One K = 4 round over the 4-rank group against the reference's
    ``shard_map`` round: the tolerances of the module docstring; rank
    k's ``ef:`` residual against the reference's shard k."""
    got = dist[0]["one"][codec][0]
    np.testing.assert_allclose(got["loss"].numpy(),
                               sharded[codec + "/loss"][0], rtol=1e-5)
    atol = ROUND_CODECS[codec]
    for (key, a), b in zip(tree_flatten_with_path(got["params"]),
                           _leaves(sharded, codec + "/params")):
        a = a.numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=key)
        assert np.mean(np.abs(a - b) > 2e-7) < 5e-3, key
    for name in ("mu", "nu"):
        for a, b in zip(tree_leaves(got[name]),
                        _leaves(sharded, f"{codec}/{name}")):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                       atol=1e-6 * np.abs(b).max())
    assert got["count"] == H
    if got["state"] is not None:
        ref = _leaves(sharded, codec + "/state")
        for r in range(K):
            for a, b in zip(tree_leaves(dist[r]["one"][codec][0]["state"]),
                            ref):
                np.testing.assert_allclose(a.numpy(), b[r], rtol=0,
                                           atol=K * atol)
                assert np.mean(np.abs(a.numpy() - b[r]) > 2e-7) < 5e-3


@pytest.mark.parametrize("codec", LOSSY)
def test_rounds_across_ranks_equal_virtual_round(dist, dist_virtual, codec):
    """Under a lossy codec every rank ends each round with
    ``virtual_round``'s params, bit for bit (one round with the opt-state
    sync, two without), and rank k's residual is row k of the virtual
    ``(K, L)`` residual."""
    want = dist_virtual[codec]
    assert _equal(dist[0]["one"][codec][0]["params"], want[0]["params"])
    assert _equal(dist[0]["two"][codec][1]["params"], want[1]["params"])
    for r in range(K):
        for run, t in (("one", 0), ("two", 0), ("two", 1)):
            got = dist[r][run][codec][t]
            assert got["hash"] == _hash(want[t]["params"]), (r, run, t)
            if got["state"] is not None:
                assert _equal(got["state"], tree_map(lambda x: x[r],
                                                     want[t]["state"]))


def test_f32_and_the_opt_state_follow_the_all_reduce(dist, dist_virtual):
    """The ``f32`` mean and the opt-state sync add in gloo's order: at
    K = 4 within 5e-7 (params) and rtol 1e-6 plus 1e-6 of each leaf's
    largest |value| (mu, nu: every codec's, which round 1 leaves equal);
    at K = 2 bit for bit."""
    want = dist_virtual["f32"]
    for a, b in zip(tree_leaves(dist[0]["one"]["f32"][0]["params"]),
                    tree_leaves(want[0])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-7)
    for c in DIST_CODECS:
        got = dist[0]["one"][c][0]
        for name in ("mu", "nu"):
            for a, b in zip(tree_leaves(got[name]),
                            tree_leaves(want[1][name])):
                np.testing.assert_allclose(
                    a.numpy(), b.numpy(), rtol=1e-6,
                    atol=1e-6 * float(b.abs().max()))
    for c in K2_CODECS:
        got, (p, o, _) = dist[0]["pair"][c][0], dist_virtual["pair", c]
        assert _equal(got["params"], p)
        assert _equal(got["mu"], o["mu"]) and _equal(got["nu"], o["nu"])
        assert dist[1]["pair"][c][0]["hash"] == got["hash"]


def test_average_by_params_equals_by_delta_across_ranks(dist):
    by_p = dist[0]["by_params"][0]["params"]
    for a, b in zip(tree_leaves(by_p),
                    tree_leaves(dist[0]["one"]["f32"][0]["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=5e-7)
    assert all(d["by_params"][0]["hash"] == dist[0]["by_params"][0]["hash"]
               for d in dist)


@pytest.mark.parametrize("codec", DIST_CODECS)
def test_recorded_bytes_and_wire_dtypes_across_ranks(reduced, dist, codec):
    """Every rank, every round: the delta exchange's recorded calls come
    to ``delta_wire_bytes`` (and ``metrics["wire_bytes"]`` says so); the
    opt-state sync's, recorded apart, to 2 K 4 bytes a float element of
    mu and nu, and to nothing without the sync; the payload travels in
    the codec's wire dtype, never as an f32 over 4 bytes when the codec
    quantizes."""
    params = reduced["params"]
    want = delta_wire_bytes(params, LocalUpdatesConfig(codec=codec), K)
    opt_bytes = 2 * K * 4 * 2 * tree_params(params)
    fused = SimpleNamespace(backend="xla",
                            scheme=SimpleNamespace(transport="compressed"))
    for r in range(K):
        runs = dist[r]["one"][codec] + dist[r]["two"][codec]
        for t, got in enumerate(runs):
            log = CollectiveLog(got["delta_log"])
            assert derived_round_traffic(log, fused, K) == want
            assert got["wire"] == want
            assert quantized_wire_dtypes(log) == WIRE[codec]
            if WIRE[codec]:
                assert not any(c.dtype == "float32" and c.nbytes > 4
                               for c in payload_collectives(log))
            if t == 0:
                assert derived_round_traffic(got["opt_log"], fused,
                                             K) == opt_bytes
            else:
                assert got["opt_log"] is None
            assert {c.round for c in log} == {1 if t < 2 else 2}


def test_H1_sgd_equals_synchronous_data_parallelism_across_ranks(dist):
    """``tests/test_distributed.py``'s property on the 4-rank group: one
    H = 1 round of plain SGD (tuple batches, the Fabric as ``axis_name``)
    is one step on the whole batch."""
    (X, Y), _ = _toy_data()
    w = torch.zeros(3).requires_grad_(True)
    g, = torch.autograd.grad(torch.mean((X.reshape(-1, 3) @ w
                                         - Y.reshape(-1)) ** 2), w)
    w_ref = -0.1 * g
    for d in dist:
        assert float(torch.max(torch.abs(d["h1"] - w_ref))) < 1e-6


def test_codec_delta_exchange_across_ranks(dist):
    """The reference's codec test on the 4-rank group: int8, int4 and
    int2 track the exact f32 round within their grid's multiple, and an
    all-zero delta (lr = 0) comes back exactly zero under every codec."""
    _, (_, _, w0) = _toy_data()
    toy = dist[0]["toy"]
    d_f32 = float(torch.max(torch.abs(toy["f32", 0.05] - w0)))
    assert d_f32 > 0
    for codec, mult in (("int8", 1.0), ("int4", 17.0), ("int2", 85.0)):
        err = float(torch.max(torch.abs(toy[codec, 0.05] - toy["f32", 0.05])))
        assert err <= 0.02 * mult * max(d_f32, 1e-9), (codec, err, d_f32)
    for codec in ("f32", "int8", "int4", "int2", "topk(r=0.25)", "ef:int4"):
        assert torch.equal(toy[codec, 0.0], w0), codec
    for d in dist[1:]:
        for key, w in d["toy"].items():
            assert torch.equal(w, toy[key]), key


def test_grad_sync_axis_keeps_every_rank_equal(dist):
    """``make_train_step(grad_sync_axis=...)``: after two steps every
    rank of the group holds the same params, and the pair's (a process
    group) are, bit for bit, one process's AdamW steps on (g0 + g1) / 2."""
    assert len({d["grad_sync"] for d in dist}) == 1
    assert dist[0]["pair_grad_sync"] == dist[1]["pair_grad_sync"] == \
        dist[0]["pair_grad_sync_one_process"]
    assert dist[0]["grad_sync"] != dist[0]["pair_grad_sync"]


def test_grad_sync_axis_matches_the_sharded_reference(sharded, dist):
    """Two steps of ``make_train_step(grad_sync_axis=<Fabric>)`` on the
    4-rank group, rank k on shard k's batches, against the reference's
    ``make_train_step(grad_sync_axis="data")`` under ``shard_map`` on
    the same carried params and batches: the f32 round's tolerances."""
    got = dist[0]["grad_sync_state"]
    assert len(_leaves(sharded, "grad_sync/params")) == len(
        tree_leaves(got["params"]))
    for (key, a), b in zip(tree_flatten_with_path(got["params"]),
                           _leaves(sharded, "grad_sync/params")):
        a = a.numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=ROUND_CODECS["f32"],
                                   err_msg=key)
        assert np.mean(np.abs(a - b) > 2e-7) < 5e-3, key
    for name in ("mu", "nu"):
        for a, b in zip(tree_leaves(got[name]),
                        _leaves(sharded, f"grad_sync/{name}")):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                       atol=1e-6 * np.abs(b).max())


# -- checkpoint -------------------------------------------------------------

def test_checkpoint_moves_between_the_packages(reduced, tmp_path):
    rm = reduced["rm"]
    ref_bf = jax.device_get(jax.jit(rm.init)(jax.random.key(1)))
    params = params_from_reference(ref_bf, device="cpu")
    opt = adamw_init(params, AdamWConfig())
    tree = {"params": params, "opt": opt}
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, tree, step=7)
    like = {"params": ref_bf, "opt": ref_adamw_init(ref_bf,
                                                   RefAdamWConfig())}
    got, step = ref_restore(path, like)
    assert step == 7
    assert jax.tree.structure(got) == jax.tree.structure(like)
    want = {"params": params_to_reference(params),
            "opt": params_to_reference(opt)}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # and the other way
    rpath = str(tmp_path / "ref.npz")
    ref_save(rpath, like, step=3)
    back, step = restore_checkpoint(rpath, tree)
    assert step == 3
    for a, b in zip(tree_leaves(back), jax.tree.leaves(like)):
        assert params_to_reference(a).tobytes() == np.asarray(b).tobytes()
    with open(path + ".meta.json") as f, open(rpath + ".meta.json") as g:
        assert json.load(f)["dtypes"] == json.load(g)["dtypes"]


def test_launch_train_on_the_cpu_restores_in_the_reference(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` with local
    rounds under ``compressed:int8``: the rounds run, the byte model is
    printed over the run's one device, and its checkpoint restores in
    the reference's ``restore_checkpoint``."""
    from repro_torch.launch import train
    ckpt = str(tmp_path / "ck.npz")
    train.main(["--reduced", "--steps", "4", "--batch", "2", "--seq", "32",
                "--local-H", "2", "--exchange", "compressed:int8",
                "--ckpt", ckpt, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "modelled per sync across 1 shard(s)" in out
    assert "round 1 (H=2)" in out and "saved" in out
    rm = ref_build_model(ref_get_config(ARCH).reduced())
    like = jax.eval_shape(rm.init, jax.random.key(0))
    like = {"params": like, "opt": jax.eval_shape(
        lambda p: ref_adamw_init(p, RefAdamWConfig()), like)}
    got, step = ref_restore(ckpt, like)
    assert step == 4 and int(got["opt"]["count"]) == 4
    # the MoE family with MLA and MTP trains on the CPU at --reduced
    train.main(["--arch", "deepseek-v3-671b", "--reduced", "--steps", "2",
                "--batch", "2", "--seq", "16", "--local-H", "2",
                "--device", "cpu"])
    assert "round 0 (H=2)" in capsys.readouterr().out
