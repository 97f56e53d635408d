"""The recurrent-state families against the reference on the CPU: the
RG-LRU's doubling scan and the SSD's chunked scan against plain step
loops and the reference's own functions, the causal conv1d step by step,
and mamba2-2.7b and recurrentgemma-9b at ``.reduced()`` on the
reference's carried params (``models.carry``): loss and gradients over
three SSD chunks, the padded branch of the SSD, the ``{h, conv}`` states
carried both ways, states written in place, and recurrentgemma's local
attention past its window.

The reference's runs are made once, in a module-scoped fixture.

Tolerances: f32 at rtol 1e-4 with atol 1e-5 of the largest value (the
f32 logits and gradients of ``test_torch_transformer.py``; sum orders
only: the doubling scan and the pairwise products of the chunked SSD add
in another order than ``lax.associative_scan`` and the 4-operand
einsums); the loss at rtol 1e-5 (``test_torch_serve.py``'s f32 loss).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.train.loss import lm_loss as ref_lm_loss
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.carry import (params_from_reference,
                                      states_from_reference,
                                      states_to_reference)
from repro_torch.train.loss import lm_loss
from repro_torch.utils.trees import (tree_flatten_with_path, tree_leaves,
                                     tree_unflatten)

ARCHS = ("mamba2-2.7b", "recurrentgemma-9b")
B = 2
S_LONG = 96            # three SSD chunks of 32 at .reduced()
S_PAD = 24             # not a multiple of the chunk: the padded branch
S_RING, N_RING = 80, 8  # past recurrentgemma's reduced local window of 64


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def _positions(t):
    return np.full((B, 1), t, np.int32)


def _close(got, want, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max(),
                               err_msg=err_msg)


@pytest.fixture(scope="module")
def runs():
    """Per arch, at ``.reduced()`` in f32 with f32 states: the
    reference's params, its loss and gradients at S = 96, its prefill of
    S = 24 (logits and states), and its prefill of S = 80 and 8 decode
    steps (every logits array and the final states)."""
    out = {}
    for arch in ARCHS:
        rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
        rm, m = ref_build_model(rcfg), build_model(cfg)
        rp = jax.device_get(jax.jit(lambda k: rm.init(k, jnp.float32))(
            jax.random.key(0)))
        batch = TokenStream(cfg.vocab_size, S_LONG, B, seed=5).next_batch()
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: ref_lm_loss(rm, p, b)[0]))(rp, batch)
        prefill = jax.jit(lambda p, b, st: rm.prefill(p, b, st))
        step = jax.jit(lambda p, b, st: rm.decode_step(p, b, st))
        pad_prompts = _tokens(cfg.vocab_size, (B, S_PAD), 7)
        lg, st = prefill(rp, {"tokens": jnp.asarray(pad_prompts)},
                         rm.init_states(rp, B, S_PAD + 1,
                                        dtype=jnp.float32))
        ring_prompts = _tokens(cfg.vocab_size, (B, S_RING), 8)
        ring_toks = _tokens(cfg.vocab_size, (B, N_RING), 9)
        r_lg, rst = prefill(rp, {"tokens": jnp.asarray(ring_prompts)},
                            rm.init_states(rp, B, S_RING + N_RING,
                                           dtype=jnp.float32))
        ring = [np.asarray(r_lg)]
        for t in range(N_RING):
            r_lg, rst = step(rp, {
                "tokens": jnp.asarray(ring_toks[:, t:t + 1]),
                "positions": jnp.asarray(_positions(S_RING + t))}, rst)
            ring.append(np.asarray(r_lg))
        out[arch] = dict(
            m=m, cfg=cfg, rp=rp, batch=batch, loss=float(loss),
            grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
            pad_prompts=pad_prompts, pad_logits=np.asarray(lg),
            pad_states=jax.device_get(st), ring_prompts=ring_prompts,
            ring_toks=ring_toks, ring_logits=ring,
            ring_states=jax.device_get(rst))
    return out


def _params(a):
    return params_from_reference(a["rp"], a["cfg"], device="cpu")


# -- the scans and the conv, alone --------------------------------------

def _rglru_inputs(S, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, 8)).astype(np.float32)
    r, i = (rng.uniform(0.0, 1.0, (2, S, 8)).astype(np.float32)
            for _ in range(2))
    lam = np.log(np.expm1(rng.uniform(1e-4, 0.5, 8))).astype(np.float32)
    return x, r, i, lam


@pytest.mark.parametrize("S", [1, 2, 37, 64])
def test_doubling_scan_matches_a_sequential_loop(S):
    """The doubling scan against the recurrence step by step (f64) and
    against the reference's ``lax.associative_scan``."""
    x, r, i, lam = _rglru_inputs(S, seed=S)
    got = L._rglru_scan(*map(torch.tensor, (x, r, i, lam))).numpy()
    log_a = -L._RGLRU_C * r * np.logaddexp(lam, 0.0)
    a = np.exp(log_a.astype(np.float64))
    g = np.sqrt(np.maximum(1.0 - np.exp(2.0 * log_a.astype(np.float64)),
                           1e-6)) * (i * x)
    h, want = np.zeros((2, 8)), np.empty((2, S, 8))
    for t in range(S):
        h = a[:, t] * h + g[:, t]
        want[:, t] = h
    _close(got, want)
    _close(got, jax.jit(RL._rglru_scan)(*map(jnp.asarray, (x, r, i, lam))))


def _ssd_inputs(S, H, G, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S, H, 4)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (2, S, H)).astype(np.float32)
    A = np.log(rng.uniform(1.0, 4.0, H)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((2, S, G, 3)).astype(np.float32)
              for _ in range(2))
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_matches_the_step_recurrence(G):
    """Four chunks of 8 against ``h = exp(dt A) h + dt B x; y = C h``
    step by step (f64), heads sharing B and C by groups as
    ``jnp.repeat`` shares them (head h reads group h // (H / G)), and
    against the reference's ``_ssd_chunked``."""
    H = 4
    x, dt, A, Bm, Cm = _ssd_inputs(32, H, G, seed=G)
    y, hT = L._ssd_chunked(*map(torch.tensor, (x, dt, A, Bm, Cm)), 8)
    grp = np.arange(H) // (H // G)
    Bh, Ch = Bm[:, :, grp].astype(np.float64), Cm[:, :, grp]
    dA = np.exp(dt * -np.exp(A)).astype(np.float64)
    h, want = np.zeros((2, H, 4, 3)), np.empty(x.shape)
    for t in range(32):
        h = (dA[:, t, :, None, None] * h + dt[:, t, :, None, None]
             * x[:, t, :, :, None] * Bh[:, t, :, None, :])
        want[:, t] = np.einsum("bhpn,bhn->bhp", h, Ch[:, t])
    _close(y.numpy(), want)
    _close(hT.numpy(), h)
    ry, rh = jax.jit(RL._ssd_chunked, static_argnums=5)(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), 8)
    _close(y.numpy(), ry)
    _close(hT.numpy(), rh)


def test_conv1d_step_by_step_equals_the_full_sequence():
    """Feeding a sequence one token at a time through the conv tail gives
    the full-sequence conv, and the tail after it; both as the
    reference's (f32)."""
    rng = np.random.default_rng(3)
    p = {"w": rng.standard_normal((4, 6)).astype(np.float32),
         "b": rng.standard_normal(6).astype(np.float32)}
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    tail = torch.zeros((2, 3, 6))
    full, tail = L.conv1d_apply(tp, torch.tensor(x), mode="full", state=tail)
    step = torch.zeros((2, 3, 6))
    ys = [L.conv1d_apply(tp, torch.tensor(x[:, t:t + 1]), mode="step",
                         state=step)[0] for t in range(9)]
    _close(torch.cat(ys, 1).numpy(), full.numpy())
    assert torch.equal(step, tail)
    want, want_tail = RL.conv1d_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        mode="full", state=jnp.zeros((2, 3, 6)))
    _close(full.numpy(), want)
    np.testing.assert_array_equal(tail.numpy(), np.asarray(want_tail))


# -- the two archs against the reference -----------------------------------

def _port_grads(m, params, batch):
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = lm_loss(m, tree_unflatten(params, live), batch)
    return loss, [g.float().numpy()
                  for g in torch.autograd.grad(loss, live)]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_over_three_chunks_match_reference(runs, arch):
    """S = 96 (three SSD chunks of 32 for mamba2): the f32 loss and every
    gradient leaf as the reference's ``jax.value_and_grad``, all finite
    (the masked exp of the chunked SSD; the reference's regression test
    is ``tests/test_models_smoke.py::test_ssd_gradients_finite_longer_seq``)."""
    a = runs[arch]
    params = _params(a)
    batch = {k: torch.tensor(v) for k, v in a["batch"].items()}
    loss, grads = _port_grads(a["m"], params, batch)
    np.testing.assert_allclose(float(loss.detach()), a["loss"], rtol=1e-5)
    assert len(grads) == len(a["grads"])
    for (key, _), g, r in zip(tree_flatten_with_path(params), grads,
                              a["grads"]):
        assert np.isfinite(g).all(), key
        _close(g, r, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_grads_over_three_chunks_are_finite(runs, arch):
    """The reference's regression test in the port: bf16 params, S = 96."""
    a = runs[arch]
    params = a["m"].init(torch.Generator().manual_seed(0))
    batch = {k: torch.tensor(v) for k, v in a["batch"].items()}
    loss, grads = _port_grads(a["m"], params, batch)
    assert bool(torch.isfinite(loss))
    assert all(np.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_padded_prefill_matches_reference(runs, arch):
    """S = 24, not a multiple of the SSD chunk: the padded steps (dt = 0
    after the softplus) leave the final state as the reference's; the
    logits and every state (f32) as the reference's."""
    a = runs[arch]
    m, params = a["m"], _params(a)
    st = m.init_states(params, B, S_PAD + 1, dtype=torch.float32)
    with torch.inference_mode():
        lg, st = m.prefill(params,
                           {"tokens": torch.tensor(a["pad_prompts"])}, st)
    _close(lg.numpy(), a["pad_logits"])
    for g, w in zip(states_to_reference(st), a["pad_states"]):
        assert sorted(g) == sorted(w)
        for key in w:
            if key == "pos_abs":
                np.testing.assert_array_equal(g[key], w[key])
            else:
                _close(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_states_carry_both_ways_bit_for_bit(runs, arch):
    """The reference's prefilled ``{h, conv}`` (and KV) states into the
    port and back, and the port's own back and forth, every bit and
    dtype kept."""
    a = runs[arch]
    want = a["pad_states"]
    back = states_to_reference(states_from_reference(want, device="cpu"))
    for g, w in zip(back, want):
        assert sorted(g) == sorted(w)
        for key in w:
            assert g[key].dtype == w[key].dtype
            assert np.array_equal(g[key].view(np.uint8),
                                  np.asarray(w[key]).view(np.uint8))
    m, params = a["m"], _params(a)
    st = m.init_states(params, B, S_PAD + 1)
    with torch.inference_mode():
        m.prefill(params, {"tokens": torch.tensor(a["pad_prompts"])}, st)
    again = states_from_reference(states_to_reference(st), device="cpu")
    for g, w in zip(again, st):
        for key in w:
            assert g[key].dtype == w[key].dtype and torch.equal(g[key],
                                                                w[key])


@pytest.mark.parametrize("arch", ARCHS)
def test_states_are_written_in_place(runs, arch):
    """Prefill and decode steps return the dicts they were given and
    write into their tensors: no state tensor moves."""
    a = runs[arch]
    m, params = a["m"], _params(a)
    st = m.init_states(params, B, S_PAD + 2)
    ptrs = [{k: v.data_ptr() for k, v in d.items()} for d in st]
    with torch.inference_mode():
        _, st1 = m.prefill(params,
                           {"tokens": torch.tensor(a["pad_prompts"])}, st)
        h_prefill = [d["h"].clone() for d in st if "h" in d]
        _, st2 = m.decode_step(params, {
            "tokens": torch.tensor(a["pad_prompts"][:, :1]),
            "positions": torch.tensor(_positions(S_PAD))}, st1)
    assert all(x is y is z for x, y, z in zip(st, st1, st2))
    assert [{k: v.data_ptr() for k, v in d.items()} for d in st2] == ptrs
    hs = [d["h"] for d in st2 if "h" in d]
    assert hs and all(h0.any() and not torch.equal(h0, h)
                      for h0, h in zip(h_prefill, hs))


@pytest.mark.parametrize("arch", ARCHS)
def test_long_prompt_decode_matches_reference(runs, arch):
    """A prompt of 80 and 8 decode steps (f32): every logits array and
    every final state as the reference's. For recurrentgemma this runs
    past its local window of 64: the prefill keeps the last 64 positions
    and each step overwrites the slot ``pos % 64``."""
    a = runs[arch]
    m, params = a["m"], _params(a)
    st = m.init_states(params, B, S_RING + N_RING, dtype=torch.float32)
    with torch.inference_mode():
        lg, st = m.prefill(params,
                           {"tokens": torch.tensor(a["ring_prompts"])}, st)
        got = [lg.numpy()]
        for t in range(N_RING):
            lg, st = m.decode_step(params, {
                "tokens": torch.tensor(a["ring_toks"][:, t:t + 1]),
                "positions": torch.tensor(_positions(S_RING + t))}, st)
            got.append(lg.numpy())
    for g, r in zip(got, a["ring_logits"]):
        _close(g, r)
    last = S_RING + N_RING - 1
    window = a["cfg"].rglru.local_window if a["cfg"].rglru else None
    for g, w in zip(states_to_reference(st), a["ring_states"]):
        assert sorted(g) == sorted(w)
        for key in w:
            if key == "pos_abs":
                np.testing.assert_array_equal(g[key], w[key])
                assert sorted(g[key][0]) == list(
                    range(last - window + 1, last + 1))
            else:
                _close(g[key], w[key], err_msg=key)
