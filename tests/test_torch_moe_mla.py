"""The MoE family against the reference on the CPU: llama4-maverick (128
experts top-1 and a shared expert; here 4 experts) and deepseek-v3 (a
dense prologue, MLA, 256 experts top-8 and a shared expert, and the
multi-token prediction head; here 4 experts top-2) at ``.reduced()``, on
the reference's carried params (``models.carry``): the router, the
capacity dispatch tables, the combine, ``moe_apply``, ``mla_apply`` in
both modes with its latent cache, logits, prefill and decode steps,
``forward_train_mtp``, ``lm_loss`` with MTP and its gradients, decode
against teacher forcing without drops, and the carry of the prologue,
the MTP head and the MLA states.

The reference's runs are made once, in a module-scoped fixture.

Tolerances: the dispatch tables and the bf16 combine bit for bit; a
single module in f32 at rtol 1e-5 (atol 1e-5 of its largest value) and
in bf16 equal; logits, losses and gradients in f32 at rtol 1e-4 with
atol 1e-5 of the largest value (sum orders only); bf16 logits under
``test_torch_transformer.py``'s rule (2e-2 of the largest logit
everywhere, and no more elements outside rtol = atol = 2e-2 than twice
the reference's own op-by-op run has); decode against teacher forcing
at the reference's own 0.15 in log-softmax
(``tests/test_models_smoke.py``).
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
from repro.models.registry import states_max_len as ref_states_max_len
from repro.train.loss import lm_loss as ref_lm_loss
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.carry import (params_from_reference,
                                      params_to_reference,
                                      states_from_reference,
                                      states_to_reference, tensor_from_numpy)
from repro_torch.models.registry import states_max_len
from repro_torch.train.loss import lm_loss
from repro_torch.utils.trees import (tree_flatten_with_path, tree_leaves,
                                     tree_map, tree_params, tree_unflatten)

ARCHS = ("llama4-maverick-400b-a17b", "deepseek-v3-671b")
MLA_ARCH = "deepseek-v3-671b"
B, S, N = 2, 16, 4          # batch, prompt, decode steps fed seeded tokens
TF_TOL = 0.15               # tests/test_models_smoke.py's decode bound
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def _positions(t, b=B):
    return np.full((b, 1), t, np.int32)


def _train_batch(cfg, seed=0):
    toks = _tokens(cfg.vocab_size, (B, 2 * S), seed)
    return {"tokens": toks, "labels": np.concatenate(
        [toks[:, 1:], np.full((B, 1), -100, np.int32)], 1)}


def _t(tree):
    return tree_map(lambda v: tensor_from_numpy(v, "cpu"), tree)


def _j(batch) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, rtol=1e-4, err_msg=""):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32), want,
                               rtol=rtol, atol=1e-5 * np.abs(want).max(),
                               err_msg=err_msg)


def _outside(a, b, tol=2e-2) -> int:
    """Elements of ``a`` outside rtol = atol = ``tol`` of ``b``."""
    return int(np.sum(np.abs(a - b) > tol + tol * np.abs(b)))


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _no_excess(fn, *args):
    """``fn`` jitted with ``xla_allow_excess_precision`` off: every bf16 op
    rounded, as in the reference's op-by-op run (``jax.disable_jit``),
    which gives these runs' bits (prefill and decode steps of both archs
    at these shapes) in a second where it takes thirty."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _ref_serve(rm, params, prompts, toks, cache_dtype, *, eager=False):
    """The reference's prefill and N decode steps (jitted, or with every
    op rounded, ``_no_excess``): the logits and the states after the
    prefill, after the first step and at the end, as numpy."""
    prefill = jax.jit(lambda p, b, st: rm.prefill(p, b, st))
    step = jax.jit(lambda p, b, st: rm.decode_step(p, b, st))
    st = rm.init_states(params, B, S + N, dtype=cache_dtype)
    batch = {"tokens": jnp.asarray(prompts)}
    if eager:
        prefill = _no_excess(lambda p, b, st: rm.prefill(p, b, st), params,
                             batch, st)
    logits, st = prefill(params, batch, st)
    out = {"prefill": np.asarray(logits), "steps": [],
           "states_prefill": jax.device_get(st)}
    for t in range(N):
        batch = {"tokens": jnp.asarray(toks[:, t:t + 1]),
                 "positions": jnp.asarray(_positions(S + t))}
        if eager and t == 0:
            step = _no_excess(lambda p, b, st: rm.decode_step(p, b, st),
                              params, batch, st)
        logits, st = step(params, batch, st)
        out["steps"].append(np.asarray(logits))
        if t == 0:
            out["states_step1"] = jax.device_get(st)
    out["states_end"] = jax.device_get(st)
    return out


def _port_serve(m, params, prompts, toks, cache_dtype):
    st = m.init_states(params, B, S + N, dtype=cache_dtype)
    with torch.inference_mode():
        logits, st = m.prefill(params, {"tokens": torch.tensor(prompts)}, st)
        out = {"prefill": logits.numpy(), "steps": []}
        for t in range(N):
            logits, st = m.decode_step(
                params, {"tokens": torch.tensor(toks[:, t:t + 1]),
                         "positions": torch.tensor(_positions(S + t))}, st)
            out["steps"].append(logits.numpy())
    out["states"] = st
    return out


@pytest.fixture(scope="module")
def runs():
    """Per arch: both packages' models, the reference's params in bf16
    and f32, the prompts and step tokens, the reference's serving runs
    (bf16 also with every op rounded), and its f32 train forward, MTP
    logits, loss and gradients on one train batch."""
    out = {}
    for arch in ARCHS:
        rcfg = ref_get_config(arch).reduced()
        cfg = get_config(arch).reduced()
        rm, m = ref_build_model(rcfg), build_model(cfg)
        a = dict(rm=rm, m=m, rcfg=rcfg, cfg=cfg, params={}, ref={},
                 prompts=_tokens(cfg.vocab_size, (B, S), 1),
                 toks=_tokens(cfg.vocab_size, (B, N), 2),
                 batch=_train_batch(cfg))
        # the bf16 tree is the f32 one with its bf16 leaves rounded: the
        # reference draws each in f32 and casts it (bit for bit the
        # bf16 init's, in half the time)
        f32 = jax.device_get(jax.jit(lambda k: rm.init(k, jnp.float32))(
            jax.random.key(0)))
        like = jax.eval_shape(lambda k: rm.init(k, jnp.bfloat16),
                              jax.random.key(0))
        a["params"] = {"f32": f32, "bf16": jax.tree.map(
            lambda x, l: np.asarray(x).astype(l.dtype), f32, like)}
        for name, (jdt, _) in DTYPES.items():
            a["ref"][name] = _ref_serve(rm, a["params"][name], a["prompts"],
                                        a["toks"], jdt)
        a["ref"]["bf16_eager"] = _ref_serve(rm, a["params"]["bf16"],
                                            a["prompts"], a["toks"],
                                            jnp.bfloat16, eager=True)
        def train(p, b):
            loss_fn = lambda p: ref_lm_loss(rm, p, b)      # noqa: E731
            return (rm.forward_train(p, b),
                    rm.forward_train_mtp(p, b) if cfg.mtp_depth else None,
                    jax.value_and_grad(loss_fn, has_aux=True)(p))
        fwd, a["mtp"], ((a["loss"], a["metrics"]), grads) = jax.device_get(
            jax.jit(train)(a["params"]["f32"], _j(a["batch"])))
        a["train_logits"], a["train_aux"] = fwd
        a["grads"] = [np.asarray(g) for g in jax.tree.leaves(grads)]
        out[arch] = a
    return out


def _params(a, dtype="f32"):
    return params_from_reference(a["params"][dtype], a["cfg"], device="cpu")


def _channel(rparams):
    """The first MoE layer's channel params of a reference tree."""
    return jax.tree.map(lambda x: np.asarray(x)[0],
                        rparams["stack"][0]["channel"])


# -- configs, the tree, the random init ----------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_tree(runs, arch):
    """The port's own init: the reference's leaves (paths, shapes,
    dtypes), the prologue and the MTP head among them; at full width too
    (on the meta device, against ``jax.eval_shape``)."""
    a = runs[arch]
    mine = a["m"].init(torch.Generator().manual_seed(0))
    assert [(k, tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree_flatten_with_path(mine)] == [
        (k, tuple(v.shape), str(v.dtype)) for k, v in tree_flatten_with_path(
            params_to_reference(_params(a, "bf16")))]
    assert len(mine["prologue"]) == a["cfg"].moe.first_k_dense
    assert ("mtp" in mine) == (a["cfg"].mtp_depth > 0)
    full = get_config(arch)
    with torch.device("meta"):
        big = build_model(full).init(None)
    shapes = jax.eval_shape(ref_build_model(ref_get_config(arch)).init,
                            jax.random.key(0))
    assert [tuple(x.shape) for x in tree_leaves(big)] == [
        tuple(x.shape) for x in jax.tree.leaves(shapes)]
    assert tree_params(big) == sum(int(np.prod(x.shape))
                                   for x in jax.tree.leaves(shapes))


@pytest.mark.parametrize("arch", ARCHS)
def test_an_expert_leaf_drawn_an_expert_at_a_time_keeps_its_values(
        monkeypatch, arch):
    """Past ``layers._WHOLE_DRAW_BYTES`` even for one slot (llama4's
    (128, 5120, 8192) ``w_up``), a stacked expert leaf is drawn one
    expert at a time; on the CPU generator that gives the values of one
    whole draw, leaf for leaf."""
    m = build_model(get_config(arch).reduced())
    whole = m.init(torch.Generator().manual_seed(0))
    d, dff = m.cfg.d_model, m.cfg.moe.d_expert
    monkeypatch.setattr(L, "_WHOLE_DRAW_BYTES", 4 * d * dff)
    experts = m.init(torch.Generator().manual_seed(0))
    for a, b in zip(tree_leaves(experts), tree_leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- the router, the dispatch and the combine ------------------------------

@pytest.mark.parametrize("E,K,T,C", [(4, 1, 32, 10), (4, 2, 32, 20),
                                     (256, 8, 64, 2), (128, 1, 64, 1),
                                     (8, 2, 12, 24)])
def test_dispatch_tables_are_the_reference_bit_for_bit(E, K, T, C):
    """On the same experts and gates: tok_idx and gate_val bit for bit,
    with drops (C below the mean load) and without (C = T K)."""
    rng = np.random.default_rng(E * 100 + K)
    experts = np.stack([rng.permutation(E)[:K] for _ in range(T)]).astype(
        np.int32)
    gates = rng.random((T, K)).astype(np.float32)
    mo = dataclasses.replace(get_config(MLA_ARCH).moe, num_experts=E,
                             top_k=K)
    want = jax.device_get(jax.jit(RL._dispatch_tables, static_argnums=(
        2, 3, 4))(jnp.asarray(experts), jnp.asarray(gates), T, mo, C))
    got = L._dispatch_tables(torch.tensor(experts).long(),
                             torch.tensor(gates), T, mo, C)[:2]
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


def test_route_ties_go_to_the_lower_index():
    """``lax.top_k``'s tie rule: equal probabilities (a zero router) give
    experts 0 ... K-1, and the gates, experts and aux loss of a random
    router are the reference's."""
    mo = get_config(MLA_ARCH).reduced().moe
    x = np.random.default_rng(3).standard_normal((24, 256)).astype(
        np.float32)
    zero = {"w": np.zeros((256, mo.num_experts), np.float32)}
    _, experts, _ = L._route(_t(zero), mo, torch.tensor(x))
    assert experts.tolist() == [list(range(mo.top_k))] * 24
    w = {"w": (np.random.default_rng(4).standard_normal(
        (256, mo.num_experts)) / 16).astype(np.float32)}
    want = RL._route(_j(w), mo, jnp.asarray(x))
    got = L._route(_t(w), mo, torch.tensor(x))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    _close(got[0].numpy(), want[0], rtol=1e-6)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-6)


@pytest.mark.parametrize("K", [1, 2, 8])
def test_combine_is_the_reference_scatter_add_bit_for_bit(K):
    """bf16 rows summed per token in expert order, as the reference's
    scatter-add sums them, with drops: bit for bit (at K = 8 a sum in
    another order differs)."""
    E, T, d = 16, 40, 64
    rng = np.random.default_rng(K)
    experts = np.stack([rng.permutation(E)[:K] for _ in range(T)])
    C = max(1, int(1.0 * K * T / E))
    gates = rng.random((T, K)).astype(np.float32)
    mo = dataclasses.replace(get_config(MLA_ARCH).moe, num_experts=E,
                             top_k=K)
    tok_idx, gate_val, combine = L._dispatch_tables(
        torch.tensor(experts).long(), torch.tensor(gates), T, mo, C)
    ye = torch.tensor(rng.standard_normal((E, C, d)) * 4).to(torch.bfloat16)
    ye = ye * gate_val[..., None].to(ye.dtype)
    got = L._combine(ye.reshape(-1, d), combine)
    jye = jnp.asarray(ye.float().numpy()).astype(jnp.bfloat16)
    want = jnp.zeros((T, d), jnp.bfloat16).at[
        jnp.asarray(tok_idx.numpy()).reshape(-1)].add(jye.reshape(-1, d))
    np.testing.assert_array_equal(_bits(got.view(torch.int16).numpy()),
                                  _bits(np.asarray(want).view(np.int16)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("no_drop", [False, True])
def test_moe_apply_matches_reference(runs, arch, dtype, no_drop):
    """The first MoE layer's channel on seeded inputs: y and aux in f32
    at rtol 1e-5. In bf16 aux is the reference's exactly, and so is y
    for deepseek, bit for bit. llama4's y is its bits but where a bf16
    product's f32 sum, added up in another order than XLA's, rounds the
    other way (1-2 of its 16,384 expert products here): those reach y by
    at most one bf16 ulp of its largest value, at no more than 2% of its
    elements."""
    a = runs[arch]
    cfg = a["cfg"]
    p = _channel(a["params"][dtype])
    x = np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(DTYPES[dtype][0])
    y_w, aux_w = jax.device_get(jax.jit(lambda p, x: RL.moe_apply(
        p, a["rcfg"], x, no_drop=no_drop))(p, jx))
    y, aux = L.moe_apply(_t(p), cfg, torch.tensor(x).to(DTYPES[dtype][1]),
                         no_drop=no_drop)
    if dtype == "f32":
        _close(y.numpy(), y_w, rtol=1e-5)
        np.testing.assert_allclose(float(aux), float(aux_w), rtol=1e-5)
        return
    g, w = y.float().numpy(), np.asarray(y_w).astype(np.float32)
    assert float(aux) == float(aux_w)
    if arch == MLA_ARCH:
        np.testing.assert_array_equal(_bits(y.view(torch.int16).numpy()),
                                      _bits(np.asarray(y_w).view(np.int16)))
        return
    assert np.abs(g - w).max() <= 2.0 ** -7 * np.abs(w).max()
    assert np.sum(g != w) <= 0.02 * g.size


# -- MLA ---------------------------------------------------------------------

def test_mla_apply_matches_reference_in_both_modes(runs):
    """f32: a prefill over S positions into the latent cache, then one
    step at position S; y at rtol 1e-5, the cache's ``pos_abs`` equal and
    its c and kr at rtol 1e-5, the slots before S kept bit for bit."""
    a = runs[MLA_ARCH]
    cfg, rcfg = a["cfg"], a["rcfg"]
    p = a["params"]["f32"]["prologue"][0]["mixer"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, S + 1, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S + 1, dtype=np.int32), (B, S + 1))
    st_w = RL.init_mla_cache(rcfg, B, S + 4, dtype=jnp.float32)
    st = L.init_mla_cache(cfg, B, S + 4, dtype=torch.float32)
    assert sorted(st) == sorted(st_w) == ["c", "kr", "pos_abs"]
    for k in st:
        assert tuple(st[k].shape) == st_w[k].shape
    full = jax.jit(lambda p, x, q, s: RL.mla_apply(p, rcfg, x, q,
                                                   mode="full", state=s))
    step = jax.jit(lambda p, x, q, s: RL.mla_apply(p, rcfg, x, q,
                                                   mode="step", state=s))
    y_w, st_w = jax.device_get(full(p, jnp.asarray(x[:, :S]),
                                    jnp.asarray(pos[:, :S]), st_w))
    tensors = [st[k] for k in sorted(st)]
    y, st = L.mla_apply(_t(p), cfg, torch.tensor(x[:, :S]),
                        torch.tensor(pos[:, :S]), mode="full", state=st)
    assert [st[k] for k in sorted(st)] == tensors   # written in place
    _close(y.numpy(), y_w, rtol=1e-5)
    np.testing.assert_array_equal(st["pos_abs"].numpy(), st_w["pos_abs"])
    for k in ("c", "kr"):
        _close(st[k].numpy(), st_w[k], rtol=1e-5)
    before = {k: v.clone() for k, v in st.items()}
    y1_w, st1_w = jax.device_get(step(p, jnp.asarray(x[:, S:]),
                                      jnp.asarray(pos[:, S:]), st_w))
    y1, st = L.mla_apply(_t(p), cfg, torch.tensor(x[:, S:]),
                         torch.tensor(pos[:, S:]), mode="step", state=st)
    _close(y1.numpy(), y1_w, rtol=1e-5)
    np.testing.assert_array_equal(st["pos_abs"].numpy(), st1_w["pos_abs"])
    for k in ("c", "kr"):
        assert torch.equal(st[k][:, :S], before[k][:, :S])
        _close(st[k].numpy(), st1_w[k], rtol=1e-5)
    with pytest.raises(ValueError, match="mode"):
        L.mla_apply(_t(p), cfg, torch.tensor(x[:, :1]),
                    torch.tensor(pos[:, :1]), mode="chunk", state=None)


def test_mla_states_and_their_max_len(runs):
    """``init_states`` gives MLA layers the latent cache in the cache
    dtype; ``states_max_len`` is 0 for them, as the reference's is."""
    a = runs[MLA_ARCH]
    want = RT.init_states(a["rcfg"], 3, 40, jnp.bfloat16)
    with torch.device("cpu"):
        got = T.init_states(a["cfg"], 3, 40)
    assert len(got) == len(want) == a["cfg"].num_layers
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["c", "kr", "pos_abs"]
        for k in g:
            assert tuple(g[k].shape) == w[k].shape
            assert str(g[k].dtype).split(".")[-1] == str(w[k].dtype)
        assert bool((g["pos_abs"] == -1).all())
    assert states_max_len(got) == ref_states_max_len(want) == 0


# -- the whole model ---------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_logits_and_aux_match_reference(runs, arch):
    a = runs[arch]
    logits, aux = a["m"].forward_train(_params(a), _t(a["batch"]))
    _close(logits.detach().numpy(), a["train_logits"])
    np.testing.assert_allclose(float(aux), float(a["train_aux"]), rtol=1e-4)
    assert float(aux) > 0
    remat, aux_r = a["m"].forward_train(_params(a), _t(a["batch"]),
                                        remat=True)
    assert torch.equal(remat, logits) and torch.equal(aux_r, aux)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_and_decode_logits_match_reference(runs, arch, dtype):
    a = runs[arch]
    ref = a["ref"][dtype]
    got = _port_serve(a["m"], _params(a, dtype), a["prompts"], a["toks"],
                      DTYPES[dtype][1])
    pairs = [(got["prefill"], ref["prefill"])] + list(
        zip(got["steps"], ref["steps"]))
    if dtype == "f32":
        for g, r in pairs:
            _close(g, r)
        for g, w in zip(states_to_reference(got["states"]),
                        ref["states_end"]):
            np.testing.assert_array_equal(g["pos_abs"], w["pos_abs"])
        return
    eager = [a["ref"]["bf16_eager"]["prefill"]] + a["ref"]["bf16_eager"][
        "steps"]
    for g, r in pairs:
        assert np.abs(g - r).max() <= 2e-2 * np.abs(r).max()
    assert sum(_outside(g, r) for g, r in pairs) <= 2 * sum(
        _outside(e, r) for (_, r), e in zip(pairs, eager))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_forward_train(runs, arch):
    """The same dispatch and the same drops: the prefill's logits are
    forward_train's, bit for bit."""
    a = runs[arch]
    m, params = a["m"], _params(a, "bf16")
    batch = {"tokens": torch.tensor(a["prompts"])}
    with torch.inference_mode():
        train, _ = m.forward_train(params, batch)
        full, _ = m.prefill(params, batch, m.init_states(params, B, S + N))
    assert torch.equal(full, train)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_from_the_reference_states(runs, arch):
    """One step in the port from the reference's own prefilled states
    (f32): its logits and new states, the carried slots bit for bit."""
    a = runs[arch]
    ref = a["ref"]["f32"]
    st = states_from_reference(ref["states_prefill"], device="cpu")
    with torch.inference_mode():
        logits, st = a["m"].decode_step(
            _params(a), {"tokens": torch.tensor(a["toks"][:, :1]),
                         "positions": torch.tensor(_positions(S))}, st)
    _close(logits.numpy(), ref["steps"][0])
    for g, w, before in zip(states_to_reference(st), ref["states_step1"],
                            ref["states_prefill"]):
        assert sorted(g) == sorted(w)
        np.testing.assert_array_equal(g["pos_abs"], w["pos_abs"])
        for k in set(g) - {"pos_abs"}:
            np.testing.assert_array_equal(g[k][:, :S], before[k][:, :S])
            _close(g[k], w[k], rtol=1e-5)


def test_forward_train_mtp_matches_reference(runs):
    a = runs[MLA_ARCH]
    logits, mtp, aux = a["m"].forward_train_mtp(_params(a), _t(a["batch"]))
    want_logits, want_mtp, want_aux = a["mtp"]
    assert mtp.shape == (B, 2 * S - 1, logits.shape[-1])
    _close(logits.detach().numpy(), want_logits)
    _close(mtp.detach().numpy(), want_mtp)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(runs, arch):
    """f32: the loss, its terms (with MTP for deepseek) and every leaf's
    gradient at rtol 1e-4 (atol 1e-5 of the leaf's largest)."""
    a = runs[arch]
    params = _params(a)
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, met = lm_loss(a["m"], tree_unflatten(params, live),
                        _t(a["batch"]))
    np.testing.assert_allclose(float(loss.detach()), float(a["loss"]),
                               rtol=1e-4)
    for k in ("ce", "z_loss", "aux_loss") + (
            ("mtp_loss",) if a["cfg"].mtp_depth else ()):
        np.testing.assert_allclose(float(met[k]), float(a["metrics"][k]),
                                   rtol=1e-4, err_msg=k)
    grads = torch.autograd.grad(loss, live)
    assert len(grads) == len(a["grads"])
    for (key, _), g, w in zip(tree_flatten_with_path(params), grads,
                              a["grads"]):
        _close(g.numpy(), w, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing_without_drops(arch):
    """The port alone, bf16 params and caches, B 1, capacity_factor =
    num_experts (no token dropped in the full forward, as none is in a
    decode step): each step's log-softmax within 0.15 of the full
    forward's (the reference's ``test_decode_matches_teacher_forcing``)."""
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(1))
    n = 16
    toks = torch.tensor(_tokens(cfg.vocab_size, (1, n), 7))
    with torch.inference_mode():
        full, _ = m.forward_train(params, {"tokens": toks})
        st = m.init_states(params, 1, n)
        outs = []
        for t in range(n):
            lg, st = m.decode_step(params, {
                "tokens": toks[:, t:t + 1],
                "positions": torch.full((1, 1), t, dtype=torch.int32)}, st)
            outs.append(lg[:, 0])
    d = (torch.log_softmax(full, -1) - torch.log_softmax(
        torch.stack(outs, 1), -1)).abs().max()
    assert float(d) < TF_TOL, float(d)


# -- the carry ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_tree_and_states_carry_both_ways_bit_for_bit(runs, arch):
    """The params (the prologue and the MTP head included) in bf16 and
    f32, and the bf16 run's final states (MLA's ``{c, kr, pos_abs}``),
    both ways bit for bit with the reference's structure and keys; a
    tree of another prologue or without its MTP head refused."""
    a = runs[arch]
    for ref in (a["params"]["f32"], a["params"]["bf16"]):
        back = params_to_reference(params_from_reference(ref, a["cfg"],
                                                         device="cpu"))
        assert jax.tree.structure(back) == jax.tree.structure(ref)
        for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
            assert x.dtype == y.dtype and np.array_equal(_bits(x), _bits(y))
    keys = [k for k, _ in tree_flatten_with_path(_params(a))]
    assert keys == ["/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                             for q in p) for p, _ in
                    jax.tree_util.tree_flatten_with_path(
                        a["params"]["f32"])[0]]
    ref = a["ref"]["bf16"]["states_end"]
    back = states_to_reference(states_from_reference(ref, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert x.dtype == y.dtype and np.array_equal(_bits(x), _bits(y))
    rp = a["params"]["f32"]
    k = a["cfg"].moe.first_k_dense
    other = dataclasses.replace(a["cfg"], moe=dataclasses.replace(
        a["cfg"].moe, first_k_dense=k + 1), num_layers=3)
    with pytest.raises(ValueError, match=f"prologue holds {k} layers"):
        params_from_reference(rp, other, device="cpu")
    no_mtp = dataclasses.replace(a["cfg"], mtp_depth=1 - a["cfg"].mtp_depth)
    with pytest.raises(ValueError, match="MTP head"):
        params_from_reference(rp, no_mtp, device="cpu")


# -- the launchers -----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_reduced_on_the_cpu(capsys, arch):
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--reduced", "--batch", "2",
                "--prompt-len", "8", "--max-new", "4", "--device", "cpu"])
    assert "generated (2, 4)" in capsys.readouterr().out
