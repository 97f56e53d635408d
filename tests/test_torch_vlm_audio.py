"""The vlm and audio families against the reference on the CPU:
chatglm3-6b (2d RoPE, qkv bias), qwen2-vl-72b (M-RoPE, patch-embedding
early fusion) and whisper-tiny (the encoder-decoder with
cross-attention) at ``.reduced()`` in f32, on the reference's carried
params (``models.carry``): the RoPE styles, ``embed_inputs`` with
patches, cross-attention in both modes, the bulk cache fill where
positions share a slot, logits and ``lm_loss`` gradients, whisper's
encoder and decoder, greedy generation with each arch's extras (the
qwen2-vl run with patches, whose prefill keeps one patch in its cache as
the reference's does), the carry of whisper's tree and states, the
launcher, and the port's own bf16 decode against teacher forcing.

The reference's runs are made once, in a module-scoped fixture.

Tolerances: a single module at rtol 1e-5 / atol 1e-5; logits and
gradients at rtol 1e-4 with atol 1e-5 of the largest value (sum orders
only); the cache fill bit for bit; decode against teacher forcing at the
reference's own 0.15 in log-softmax (``tests/test_models_smoke.py``);
greedy ids compared up to the first position of a row where the
reference's top-two gap is below 1e-3 of its largest logit, ten times
the f32 logits' tolerance (``tests/test_torch_serve.py``'s rule).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.models import whisper as RW
from repro.models.registry import states_max_len as ref_states_max_len
from repro.serve import greedy_generate as ref_greedy_generate
from repro.train.loss import lm_loss as ref_lm_loss
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.carry import (params_from_reference,
                                      params_to_reference,
                                      states_from_reference,
                                      states_to_reference, tensor_from_numpy)
from repro_torch.models.registry import states_max_len
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serve import greedy_generate
from repro_torch.train import make_train_step
from repro_torch.train.loss import lm_loss
from repro_torch.utils.trees import (tree_flatten_with_path, tree_leaves,
                                     tree_unflatten)

ARCHS = ("chatglm3-6b", "qwen2-vl-72b", "whisper-tiny")
B, S, N = 2, 16, 8           # batch, prompt, greedy tokens
P_GRID = (2, 4)              # the patches' (h, w) grid at t = 0: 8 patches
TF_TOL = 0.15                # tests/test_models_smoke.py's decode bound
GREEDY_GAP = 1e-3            # of the largest logit: 10x the f32 rtol of 1e-4


def _ref_batch(cfg, B=2, S=32, seed=0):
    """``tests/test_models_smoke.py::_batch``: tokens, shifted labels and
    the family's extras (bf16 frames; 8 bf16 patches at zero
    positions), as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, min(100, cfg.vocab_size), (B, S)).astype(np.int32)
    batch = {"tokens": toks,
             "labels": np.concatenate(
                 [toks[:, 1:], np.full((B, 1), -100, np.int32)], 1)}
    if cfg.family == "audio":
        batch["frame_embeds"] = np.asarray(jnp.asarray(
            rng.standard_normal((B, cfg.encdec.source_len, cfg.d_model))
            * .02, jnp.bfloat16))
    if cfg.family == "vlm":
        P = 8
        batch["patch_embeds"] = np.asarray(jnp.asarray(
            rng.standard_normal((B, P, cfg.d_model)) * .02, jnp.bfloat16))
        batch["patch_positions"] = np.zeros((B, P, 3), np.int32)
    return batch


def _serve_extras(cfg, seed):
    """The serving runs' extras: whisper's bf16 frames; qwen2-vl's bf16
    patches on a (t = 0, h, w) grid, so that M-RoPE's h and w sections
    rotate and every patch's cache slot is 0."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frame_embeds": np.asarray(jnp.asarray(
            rng.standard_normal((B, cfg.encdec.source_len, cfg.d_model))
            * .02, jnp.bfloat16))}
    if cfg.family == "vlm":
        h, w = np.meshgrid(np.arange(P_GRID[0]), np.arange(P_GRID[1]),
                           indexing="ij")
        grid = np.stack([np.zeros_like(h), h, w], -1).reshape(-1, 3)
        P = grid.shape[0]
        return {"patch_embeds": np.asarray(jnp.asarray(
            rng.standard_normal((B, P, cfg.d_model)) * .02, jnp.bfloat16)),
                "patch_positions": np.ascontiguousarray(np.broadcast_to(
                    grid.astype(np.int32), (B, P, 3)))}
    return {}


def _t(batch) -> dict:
    return {k: tensor_from_numpy(v, "cpu") for k, v in batch.items()}


def _j(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, rtol=1e-4, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=1e-5 * np.abs(want).max(),
                               err_msg=err_msg)


def _f32_frames(batch: dict) -> dict:
    """The batch with whisper's bf16 frames as f32 (the same values): an
    f32 run throughout. Into f32 weights, bf16 frames make the first
    layer's norm round to bf16, which the jitted reference skips (XLA's
    excess precision;
    ``test_bf16_frames_encode_as_the_reference_op_by_op``)."""
    return {k: v.astype(np.float32) if k == "frame_embeds" else v
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def runs():
    """Per arch, at ``.reduced()`` in f32 (whisper's frames too): the
    reference's params, its logits and ``lm_loss`` gradients on
    ``_ref_batch``, its greedy ids with the serving extras (default bf16
    caches), and its prefill and decode steps fed those ids with f32
    caches: the logits and the states after the prefill and at the end;
    whisper's encoder output and teacher-forced decoder logits."""
    out = {}
    for arch in ARCHS:
        rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
        rm, m = ref_build_model(rcfg), build_model(cfg)
        rp = jax.device_get(jax.jit(lambda k: rm.init(k, jnp.float32))(
            jax.random.key(0)))
        batch = _f32_frames(_ref_batch(cfg))
        logits, grads = jax.jit(lambda p, b: (
            rm.forward_train(p, b)[0],
            jax.grad(lambda q: ref_lm_loss(rm, q, b)[0])(p)))(rp, _j(batch))
        prompts = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        extras = _f32_frames(_serve_extras(cfg, 2))
        ids = np.asarray(ref_greedy_generate(
            rm, rp, jnp.asarray(prompts), max_new=N,
            batch_extras=_j(extras) or None))
        step = jax.jit(lambda p, b, st: rm.decode_step(p, b, st))
        encode = jax.jit(lambda p, f: RW.encode(p, rcfg, f))
        if cfg.family == "audio":
            # Model.prefill rebuilds whisper's self caches in bf16 whatever
            # dtype init_states had; the same decode over f32 caches
            enc = encode(rp, jnp.asarray(extras["frame_embeds"]))
            st = RW.init_whisper_states(rp, rcfg, B, S + N, enc,
                                        dtype=jnp.float32)
            lg, st = jax.jit(lambda p, t, e, st: RW.decode(
                p, rcfg, t, e, mode="full", states=st))(
                    rp, jnp.asarray(prompts), enc, st)
        else:
            st = rm.init_states(rp, B, S + N, dtype=jnp.float32)
            lg, st = jax.jit(lambda p, b, st: rm.prefill(p, b, st))(
                rp, {"tokens": jnp.asarray(prompts), **_j(extras)}, st)
        serve = [np.asarray(lg)]
        st_prefill = jax.device_get(st)
        for t in range(N - 1):
            lg, st = step(rp, {"tokens": jnp.asarray(ids[:, t:t + 1]),
                               "positions": jnp.full((B, 1), S + t,
                                                     jnp.int32)}, st)
            serve.append(np.asarray(lg))
        a = dict(rm=rm, m=m, cfg=cfg, rp=rp, batch=batch,
                 logits=np.asarray(logits),
                 grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
                 prompts=prompts, extras=extras, ids=ids, serve=serve,
                 states_prefill=st_prefill, states_end=jax.device_get(st))
        if arch == "whisper-tiny":
            enc = encode(rp, jnp.asarray(batch["frame_embeds"]))
            a["enc"] = np.asarray(enc)
            a["dec"] = np.asarray(jax.jit(
                lambda p, t, e: RW.decode(p, rcfg, t, e)[0])(
                    rp, jnp.asarray(batch["tokens"]), enc))
        out[arch] = a
    return out


def _params(a):
    return params_from_reference(a["rp"], a["cfg"], device="cpu")


# -- configs and the registry ---------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference(arch, reduced):
    ref, port = ref_get_config(arch), get_config(arch)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert build_model(port).cfg is port
    if port.family != "audio":
        assert T.layer_plan(port) == RT.layer_plan(ref)


def test_audio_states_need_frames_and_report_their_length(runs):
    a = runs["whisper-tiny"]
    params = _params(a)
    with pytest.raises(ValueError, match="frame_embeds"):
        a["m"].init_states(params, B, 8)
    st = a["m"].init_states(params, B, 24, batch=_t(a["extras"]))
    assert states_max_len(st) == 24 == ref_states_max_len(
        a["rm"].init_states(a["rp"], B, 24, batch=_j(a["extras"])))
    assert sorted(st[0]) == ["cross_k", "cross_v", "self"]


# -- the modules alone -------------------------------------------------------

def test_mrope_with_three_distinct_position_components():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 4, 64)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 9, 3)).astype(np.int32)
    rc = ref_get_config("qwen2-vl-72b").reduced()
    pc = get_config("qwen2-vl-72b").reduced()
    got = L.apply_rope(torch.tensor(x), torch.tensor(pos), pc)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), rc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the w component moves its own section of the 32 rotary pairs only
    # (pairs 22..31: dims 22..31 and 54..63)
    one = pos.copy()
    one[..., 2] += 7
    moved = (L.apply_rope(torch.tensor(x), torch.tensor(one), pc)
             != got).any(dim=(0, 1, 2))
    w_dims = torch.zeros(64, dtype=torch.bool)
    w_dims[22:32] = w_dims[54:] = True
    assert torch.equal(moved, w_dims)


def test_embed_inputs_fuses_the_patches(runs):
    a = runs["qwen2-vl-72b"]
    params = _params(a)
    batch = {"tokens": a["prompts"], **a["extras"]}
    x, pos = T.embed_inputs(params, a["cfg"], _t(batch))
    rx, rpos = RT.embed_inputs(a["rp"], ref_get_config(
        "qwen2-vl-72b").reduced(), _j(batch))
    P = a["extras"]["patch_embeds"].shape[1]
    assert x.dtype == torch.float32 and tuple(pos.shape) == (B, S, 3)
    np.testing.assert_array_equal(x.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
    assert (pos[:, :P, 0] == 0).all() and (pos[:, P:, 1] ==
                                           torch.arange(P, S)).all()


@pytest.mark.parametrize("mode,Sq", [("full", 7), ("step", 1)])
def test_cross_attention_matches_reference(mode, Sq):
    rcfg = ref_get_config("whisper-tiny").reduced()
    cfg = get_config("whisper-tiny").reduced()
    rp = jax.device_get(RL.init_attention(jax.random.key(3), rcfg,
                                          jnp.float32))
    p = params_from_reference(rp, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, Sq, cfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((2, 11, cfg.num_kv_heads, cfg.head_dim))
            .astype(np.float32) for _ in range(2))
    kv_pos = np.ascontiguousarray(np.broadcast_to(
        np.arange(11, dtype=np.int32), (2, 11)))
    pos = np.full((2, Sq), 5, np.int32) + np.arange(Sq, dtype=np.int32)
    state = {"marker": torch.zeros(1)}
    got, st = L.attention_apply(p, cfg, torch.tensor(x), torch.tensor(pos),
                                mode=mode, state=state,
                                cross_kv=tuple(map(torch.tensor,
                                                   (k, v, kv_pos))))
    want, _ = RL.attention_apply(rp, rcfg, jnp.asarray(x), jnp.asarray(pos),
                                 mode=mode, state=None,
                                 cross_kv=tuple(map(jnp.asarray,
                                                    (k, v, kv_pos))))
    assert st is state
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_cache_fill_with_repeated_slots_is_the_reference_bit_for_bit(dtype):
    """Positions that share a slot (a VLM prompt's patches all at t = 0,
    and a ring of T = 8 that positions wrap round twice): the last write
    wins, as in the reference."""
    rng = np.random.default_rng(6)
    rcfg = ref_get_config("qwen2-vl-72b").reduced()
    KV, Dh, T_ = rcfg.num_kv_heads, rcfg.head_dim, 8
    for pos in (np.array([[0, 0, 0, 0, 4, 5, 6], [0, 0, 0, 1, 1, 7, 9]]),
                np.array([[3, 11, 19, 4, 12, 20, 5]] * 2)):
        pos = pos.astype(np.int32)
        k, v = (np.asarray(jnp.asarray(rng.standard_normal(
            (2, pos.shape[1], KV, Dh)), dtype)) for _ in range(2))
        cache = jax.device_get(RL.init_attn_cache(rcfg, 2, T_, dtype=dtype))
        cache["k"] = np.asarray(cache["k"]).copy()
        cache["k"][:] = np.asarray(jnp.asarray(7.0, dtype))
        want = jax.device_get(RL._cache_fill(
            {n: jnp.asarray(c) for n, c in cache.items()}, jnp.asarray(k),
            jnp.asarray(v), jnp.asarray(pos), None))
        got = L._slots_fill({n: tensor_from_numpy(c, "cpu")
                             for n, c in cache.items()},
                            {"k": tensor_from_numpy(k, "cpu"),
                             "v": tensor_from_numpy(v, "cpu")},
                            torch.tensor(pos))
        for name in ("k", "v", "pos_abs"):
            g = states_to_reference([{name: got[name]}])[0][name]
            assert g.dtype == want[name].dtype
            np.testing.assert_array_equal(g.view(np.uint8),
                                          np.asarray(want[name]).view(
                                              np.uint8))


# -- logits and gradients ---------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_logits_match_reference(runs, arch):
    a = runs[arch]
    logits, aux = a["m"].forward_train(_params(a), _t(a["batch"]))
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close(logits.numpy(), a["logits"])


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_grads_match_reference(runs, arch):
    a = runs[arch]
    params = _params(a)
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = lm_loss(a["m"], tree_unflatten(params, live), _t(a["batch"]))
    got = torch.autograd.grad(loss, live)
    assert len(got) == len(a["grads"])
    for (key, _), g, r in zip(tree_flatten_with_path(params), got,
                              a["grads"]):
        # the floor: a key bias's gradient is 0 in exact arithmetic (the
        # softmax ignores a shift shared by every key); both hold ~1e-10
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4, atol=max(
            1e-5 * np.abs(r).max(), 1e-8), err_msg=key)


def test_whisper_encoder_and_decoder_match_reference(runs):
    a = runs["whisper-tiny"]
    params, cfg = _params(a), a["cfg"]
    enc = W.encode(params, cfg, torch.tensor(a["batch"]["frame_embeds"]))
    np.testing.assert_allclose(enc.numpy(), a["enc"], rtol=1e-5, atol=1e-5)
    logits, states = W.decode(params, cfg, torch.tensor(
        a["batch"]["tokens"]), enc)
    assert states == [None] * cfg.num_layers
    _close(logits.numpy(), a["dec"])


def test_bf16_frames_encode_as_the_reference_op_by_op(runs):
    """bf16 frames into f32 weights: the first layer's norm rounds to
    bf16 and its products promote to f32, as in the reference run op by
    op (``jax.disable_jit``); jitted, XLA keeps the norm in f32 and
    differs from both by ~6e-3."""
    a = runs["whisper-tiny"]
    fe = _ref_batch(a["cfg"])["frame_embeds"]
    with jax.disable_jit():
        want = np.asarray(RW.encode(a["rp"], ref_get_config(
            "whisper-tiny").reduced(), jnp.asarray(fe)))
    got = W.encode(_params(a), a["cfg"], tensor_from_numpy(fe, "cpu"))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-tiny"])
def test_train_step_takes_the_family_batch(runs, arch):
    a = runs[arch]
    opt_cfg = AdamWConfig(lr=1e-3)
    params = _params(a)
    step = make_train_step(a["m"], opt_cfg)
    new, opt, met = step(params, adamw_init(params, opt_cfg),
                         _t(_ref_batch(a["cfg"], seed=2)))
    assert np.isfinite(float(met["loss"])) and float(met["loss"]) > 0
    assert int(opt["count"]) == 1
    assert any(not torch.equal(x, y) for x, y in zip(tree_leaves(new),
                                                       tree_leaves(params)))


# -- serving -----------------------------------------------------------------

def _port_serve(a, params):
    """The port's prefill and decode steps fed the reference's greedy
    ids (f32 caches): logits and the states after the prefill and at the
    end (numpy)."""
    m, extras = a["m"], _t(a["extras"])
    with torch.inference_mode():
        st = m.init_states(params, B, S + N, batch=extras or None,
                           dtype=torch.float32)
        lg, st = m.prefill(params, {"tokens": torch.tensor(a["prompts"]),
                                    **extras}, st)
        # a copy: on the CPU the numpy leaves share the tensors' memory,
        # which the decode steps then write
        out = {"logits": [lg.numpy()],
               "states_prefill": jax.tree.map(np.copy,
                                              states_to_reference(st))}
        for t in range(N - 1):
            lg, st = m.decode_step(params, {
                "tokens": torch.tensor(a["ids"][:, t:t + 1]),
                "positions": torch.full((B, 1), S + t, dtype=torch.int32)},
                st)
            out["logits"].append(lg.numpy())
    out["states_end"] = states_to_reference(st)
    return out


def _states_equal(got, want):
    """Positions bit for bit, the f32 cache slots and whisper's cross
    keys and values at the logits' tolerance."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.get("self", g) | {k: v for k, v in g.items() if k != "self"}
        w = w.get("self", w) | {k: v for k, v in w.items() if k != "self"}
        assert sorted(g) == sorted(w)
        np.testing.assert_array_equal(g["pos_abs"], w["pos_abs"])
        for key in sorted(set(g) - {"pos_abs"}):
            assert g[key].dtype == w[key].dtype == np.float32
            _close(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_and_states_match_reference(runs, arch):
    """The logits the reference's greedy ids came from; the caches'
    positions bit for bit (qwen2-vl's prefill keeps one patch, at slot
    0, the other patch slots empty: the reference's behaviour, which the
    port reproduces), k and v within bf16 rounding of the cache."""
    a = runs[arch]
    got = _port_serve(a, _params(a))
    for g, r in zip(got["logits"], a["serve"]):
        _close(g, r)
    _states_equal(got["states_prefill"], a["states_prefill"])
    _states_equal(got["states_end"], a["states_end"])
    if arch == "qwen2-vl-72b":
        P = a["extras"]["patch_embeds"].shape[1]
        pos = got["states_prefill"][0]["pos_abs"]
        assert (pos[:, 0] == 0).all() and (pos[:, 1:P] == -1).all()
        assert (pos[:, P:S] == np.arange(P, S)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_ids_match_reference(runs, arch):
    a = runs[arch]
    got = greedy_generate(a["m"], _params(a), torch.tensor(a["prompts"]),
                          max_new=N, batch_extras=_t(a["extras"]) or None)
    assert got.dtype == torch.int32 and got.shape == (B, N)
    lg = np.concatenate([r[:, -1:] for r in a["serve"]], 1)
    top2 = np.sort(lg, -1)[..., -2:]
    gap = (top2[..., 1] - top2[..., 0]) / np.abs(lg).max()
    compared = 0
    for b in range(B):
        close = np.flatnonzero(gap[b] < GREEDY_GAP)
        upto = close[0] if close.size else N
        np.testing.assert_array_equal(got[b, :upto].numpy(),
                                      a["ids"][b, :upto])
        compared += upto
    assert compared >= N


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_forward_train_with_the_extras(runs, arch):
    a = runs[arch]
    m = a["m"]
    params = m.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.tensor(a["prompts"]), **_t(a["extras"])}
    with torch.inference_mode():
        train, _ = m.forward_train(params, batch)
        st = m.init_states(params, B, S + N, batch=_t(a["extras"]) or None)
        full, st2 = m.prefill(params, batch, st)
    assert st2 is st or all(x is y for x, y in zip(st2, st))
    assert torch.equal(full, train)


def test_whisper_states_keep_their_tensors(runs):
    """Prefill rebuilds whisper's states in place and decode steps read
    the cross keys and values without writing them: every tensor keeps
    its address, the cross ones their values."""
    a = runs["whisper-tiny"]
    m, params = a["m"], _params(a)
    extras = _t(a["extras"])
    with torch.inference_mode():
        st = m.init_states(params, B, S + N, batch=extras)
        ptrs = [[t.data_ptr() for t in tree_leaves(x)] for x in st]
        st[0]["self"]["pos_abs"].fill_(3)          # a stale cache is emptied
        _, st2 = m.prefill(params, {"tokens": torch.tensor(a["prompts"]),
                                    **extras}, st)
        cross = [x["cross_k"].clone() for x in st2]
        for t in range(3):
            _, st2 = m.decode_step(params, {
                "tokens": torch.tensor(a["ids"][:, t:t + 1]),
                "positions": torch.full((B, 1), S + t, dtype=torch.int32)},
                st2)
    assert st2 is st
    assert [[t.data_ptr() for t in tree_leaves(x)] for x in st2] == ptrs
    assert all(torch.equal(x["cross_k"], c) for x, c in zip(st2, cross))
    assert (st2[0]["self"]["pos_abs"][:, :S + 3] ==
            torch.arange(S + 3)).all()
    assert (st2[0]["self"]["pos_abs"][:, S + 3:] == -1).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing_bf16(arch):
    """The port alone, bf16 params and caches, B 1: each decode step's
    log-softmax within 0.15 of the full forward, on a text prompt (the
    reference's ``test_decode_matches_teacher_forcing`` and
    ``test_whisper_decode_consistency``)."""
    cfg = get_config(arch).reduced()
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(1))
    n = 10 if cfg.family == "audio" else 16
    batch = {k: v[:1] for k, v in _t(_ref_batch(cfg, B=1, S=n)).items()
             if k in ("tokens", "frame_embeds")}
    with torch.inference_mode():
        full, _ = m.forward_train(params, batch)
        st = m.init_states(params, 1, n, batch=batch)
        outs = []
        for t in range(n):
            lg, st = m.decode_step(params, {
                "tokens": batch["tokens"][:, t:t + 1],
                "positions": torch.full((1, 1), t, dtype=torch.int32)}, st)
            outs.append(lg[:, 0])
    d = (torch.log_softmax(full, -1) - torch.log_softmax(
        torch.stack(outs, 1), -1)).abs().max()
    assert float(d) < TF_TOL, float(d)


# -- the carry ---------------------------------------------------------------

def test_whisper_tree_and_states_carry_both_ways_bit_for_bit(runs):
    a = runs["whisper-tiny"]
    for ref in (a["rp"], jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                                      a["rp"])):
        back = params_to_reference(params_from_reference(ref, a["cfg"],
                                                         device="cpu"))
        assert jax.tree.structure(back) == jax.tree.structure(ref)
        for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
            assert x.dtype == y.dtype and np.array_equal(
                x.view(np.uint8), np.asarray(y).view(np.uint8))
    keys = [k for k, _ in tree_flatten_with_path(_params(a))]
    assert keys == ["/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                             for q in p) for p, _ in
                    jax.tree_util.tree_flatten_with_path(a["rp"])[0]]
    with torch.device("meta"):
        mine = a["m"].init(None)
    assert [tuple(x.shape) for x in tree_leaves(mine)] == [
        x.shape for x in jax.tree.leaves(a["rp"])]
    ref = a["states_end"]
    back = states_to_reference(states_from_reference(ref, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert x.dtype == y.dtype and np.array_equal(
            x.view(np.uint8), np.asarray(y).view(np.uint8))
    other = dataclasses.replace(a["cfg"], num_layers=3)
    with pytest.raises(ValueError, match="dec_layers holds 2 layers"):
        params_from_reference(a["rp"], other, device="cpu")


# -- the launcher -----------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "whisper-tiny"])
def test_launch_serve_with_the_family_inputs(capsys, arch):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--reduced", "--batch", "2",
                "--prompt-len", "16", "--max-new", "4", "--device", "cpu"])
    assert "generated (2, 4)" in capsys.readouterr().out
    # the reference launcher's draws, in its order after the prompts
    cfg = get_config(arch).reduced()
    rng, ref_rng = np.random.default_rng(0), np.random.default_rng(0)
    rng.integers(0, 100, (2, 16))
    ref_rng.integers(0, 100, (2, 16))
    got = serve.batch_extras(cfg, 2, rng, "cpu")
    if cfg.family == "audio":
        want = {"frame_embeds": jnp.asarray(ref_rng.standard_normal(
            (2, cfg.encdec.source_len, cfg.d_model)) * 0.02, jnp.bfloat16)}
    else:
        want = {"patch_embeds": jnp.asarray(ref_rng.standard_normal(
            (2, 8, cfg.d_model)) * 0.02, jnp.bfloat16),
                "patch_positions": jnp.zeros((2, 8, 3), jnp.int32)}
    assert sorted(got) == sorted(want)
    for k, v in states_to_reference([got])[0].items():
        assert v.dtype == want[k].dtype
        np.testing.assert_array_equal(v.view(np.uint8),
                                      np.asarray(want[k]).view(np.uint8))
