"""The port's dense transformer against the reference on the CPU, at
``get_config("tinyllama-1.1b").reduced()`` (2 layers, d_model 256, vocab
512), with the reference's params carried across (``models.carry``):
configs, logits and loss, grads per leaf, flash attention against dense
attention, RoPE and the norm, and the carry itself; the configs, logits
and loss of nemotron-4-15b, command-r-35b, mamba2-2.7b and
recurrentgemma-9b too.

Tolerances: bf16 loss at rtol = atol = 2e-2 (the bf16 tolerance of
``tests/test_models_smoke.py``), bf16 logits as close to the jitted
reference as the reference's own op-by-op run is (see the test); bf16
grads per leaf at a
relative L2 error of 3e-2 (XLA keeps excess precision across fused bf16
elementwise chains where PyTorch rounds each op, which measured 1.3e-2
at most); f32 grads per leaf at rtol 1e-4 with atol 1e-5 of the leaf's
largest gradient (sum orders only; measured 1.3e-6 relative); flash
attention at the reference's own 1e-5 forward and 1e-4 backward
(``tests/test_flash_attention.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.registry import ARCHS as REF_ARCHS
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.models import transformer as RT
from repro.train.loss import lm_loss as ref_lm_loss
from repro_torch.configs import ARCHS, PENDING, get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.carry import params_from_reference, params_to_reference
from repro_torch.train.loss import lm_loss
from repro_torch.utils.trees import (tree_flatten_with_path, tree_leaves,
                                     tree_params, tree_unflatten)

ARCH = "tinyllama-1.1b"
# dense archs with partial RoPE, relu2 and layernorm (nemotron), and a
# parallel block with tied embeddings (command-r); SSD layers (mamba2),
# and RG-LRU layers with gelu and local attention (recurrentgemma)
NEW_ARCHS = ("nemotron-4-15b", "command-r-35b", "mamba2-2.7b",
             "recurrentgemma-9b")
B, S = 2, 64


@pytest.fixture(scope="module")
def setup():
    rcfg = ref_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    rm, m = ref_build_model(rcfg), build_model(cfg)
    ref = {dt: jax.device_get(jax.jit(lambda k, dt=dt: rm.init(k, dt))(
        jax.random.key(0))) for dt in (jnp.bfloat16, jnp.float32)}
    batch = TokenStream(cfg.vocab_size, S, B, seed=0).next_batch()
    return dict(rm=rm, m=m, cfg=cfg, ref=ref, batch=batch,
                tbatch={k: torch.tensor(v) for k, v in batch.items()})


def _port_grads(m, params, batch):
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = lm_loss(m, tree_unflatten(params, live), batch)
    return [g.float().numpy() for g in torch.autograd.grad(loss, live)]


def _ref_grads(rm, params, batch):
    g = jax.jit(jax.grad(lambda p, b: ref_lm_loss(rm, p, b)[0]))(params,
                                                                 batch)
    return [np.asarray(x).astype(np.float32) for x in jax.tree.leaves(g)]


def _config_equals_reference(arch, reduced):
    ref, port = ref_get_config(arch), get_config(arch)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert T.layer_plan(port) == RT.layer_plan(ref)
    assert T._period(port) == RT._period(ref)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference(reduced):
    _config_equals_reference(ARCH, reduced)


@pytest.mark.parametrize("arch", NEW_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_new_config_equals_reference(arch, reduced):
    _config_equals_reference(arch, reduced)


def test_registry_names_every_reference_arch():
    assert set(ARCHS) == set(REF_ARCHS)
    # the vlm and audio slice's three (tests/test_torch_vlm_audio.py) and
    # the MoE family's two (tests/test_torch_moe_mla.py)
    assert ARCHS == (ARCH,) + NEW_ARCHS + (
        "chatglm3-6b", "qwen2-vl-72b", "whisper-tiny",
        "llama4-maverick-400b-a17b", "deepseek-v3-671b")
    assert PENDING == ()


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "deepseek-v3-671b"])
def test_get_config_refuses_what_is_not_ported(arch):
    """Nothing is left unported: the last two archs' configs are the
    reference's (full and reduced), and only an unknown name is
    refused."""
    for reduced in (False, True):
        _config_equals_reference(arch, reduced)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config(arch + "-x")


def test_unknown_arch_and_family_raise():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")
    moe = dataclasses.replace(get_config(ARCH), family="moe")
    assert build_model(moe).cfg is moe
    with pytest.raises(ValueError, match="unknown family"):
        build_model(dataclasses.replace(get_config(ARCH), family="diffusion"))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_carry_round_trip_is_bit_for_bit(setup, dtype):
    ref = setup["ref"][dtype]
    params = params_from_reference(ref, setup["cfg"], device="cpu")
    back = params_to_reference(params)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), np.asarray(b).view(np.uint8))
    keys = [k for k, _ in tree_flatten_with_path(params)]
    assert keys == ["/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                             for q in p)
                    for p, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]


def test_carry_refuses_a_tree_of_another_config(setup):
    other = dataclasses.replace(setup["cfg"], num_layers=4)
    with pytest.raises(ValueError, match="stacks 2 layers"):
        params_from_reference(setup["ref"][jnp.bfloat16], other,
                              device="cpu")


def test_port_init_has_the_reference_tree(setup):
    params = setup["m"].init(torch.Generator().manual_seed(0))
    ref = setup["ref"][jnp.bfloat16]
    assert [(k, tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tree_flatten_with_path(params)] == [
        (k, tuple(v.shape), str(v.dtype))
        for k, v in tree_flatten_with_path(params_to_reference(
            params_from_reference(ref, device="cpu")))]
    with torch.device("meta"):
        full = build_model(get_config(ARCH)).init(None)
    shapes = jax.eval_shape(ref_build_model(ref_get_config(ARCH)).init,
                            jax.random.key(0))
    assert [tuple(x.shape) for x in tree_leaves(full)] == [
        tuple(x.shape) for x in jax.tree.leaves(shapes)]
    assert tree_params(full) == 1_100_048_384


@pytest.mark.parametrize("arch", [ARCH, "mamba2-2.7b", "recurrentgemma-9b"])
def test_a_large_leaf_drawn_a_slot_at_a_time_keeps_its_values(monkeypatch,
                                                              arch):
    """Past ``layers._WHOLE_DRAW_BYTES`` a stacked leaf is drawn one slot
    at a time (command-r-35b's full width); on the CPU generator that
    gives the values of one whole draw, leaf for leaf."""
    m = build_model(get_config(arch).reduced())
    whole = m.init(torch.Generator().manual_seed(0))
    monkeypatch.setattr(L, "_WHOLE_DRAW_BYTES", 0)
    slots = m.init(torch.Generator().manual_seed(0))
    assert len(tree_leaves(slots)) == len(tree_leaves(whole))
    for a, b in zip(tree_leaves(slots), tree_leaves(whole)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _outside(a, b, tol=2e-2) -> int:
    """Elements of ``a`` outside rtol = atol = ``tol`` of ``b``."""
    return int(np.sum(np.abs(a - b) > tol + tol * np.abs(b)))


def test_logits_and_loss_match_reference_bf16(setup):
    """Loss and metrics at rtol = atol = 2e-2. The bf16 logits cannot all
    meet that elementwise, and the reference cannot either: run op by op
    (``jax.disable_jit``, rounding every op to bf16 as PyTorch does) its
    own logits fall outside 2e-2 of its jitted ones at ~0.2% of the
    elements (XLA keeps excess precision across fused bf16 chains), by up
    to 0.039 on logits up to 3.9. So the port's logits are held to 2e-2
    of the largest logit everywhere, and to rtol = atol = 2e-2
    elementwise at no more elements than twice the reference's own
    op-by-op run misses."""
    rm, m = setup["rm"], setup["m"]
    ref = setup["ref"][jnp.bfloat16]
    params = params_from_reference(ref, setup["cfg"], device="cpu")
    r_logits = np.asarray(jax.jit(lambda p, b: rm.forward_train(p, b)[0])(
        ref, setup["batch"]))
    with jax.disable_jit():
        r_eager = np.asarray(rm.forward_train(ref, setup["batch"])[0])
    r_loss, r_met = jax.jit(lambda p, b: ref_lm_loss(rm, p, b))(
        ref, setup["batch"])
    logits, _ = m.forward_train(params, setup["tbatch"])
    loss, met = lm_loss(m, params, setup["tbatch"])
    assert logits.dtype == torch.float32
    got = logits.numpy()
    assert np.abs(got - r_logits).max() <= 2e-2 * np.abs(r_logits).max()
    assert _outside(got, r_logits) <= 2 * _outside(r_eager, r_logits)
    assert _outside(got, r_logits) <= 0.005 * got.size
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=2e-2,
                               atol=2e-2)
    for k in ("ce", "z_loss", "accuracy"):
        np.testing.assert_allclose(float(met[k]), float(r_met[k]),
                                   rtol=2e-2, atol=2e-2)


def test_logits_match_reference_f32(setup):
    rm, m = setup["rm"], setup["m"]
    ref = setup["ref"][jnp.float32]
    params = params_from_reference(ref, setup["cfg"], device="cpu")
    r_logits, _ = jax.jit(lambda p, b: rm.forward_train(p, b))(
        ref, setup["batch"])
    logits, _ = m.forward_train(params, setup["tbatch"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_logits_and_loss_match_reference(arch):
    """At ``.reduced()`` on the reference's carried params: f32 logits at
    rtol 1e-4 (atol 1e-5 of the largest), bf16 logits within 2e-2 of
    the largest, the bf16 loss at rtol = atol = 2e-2."""
    rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    rm, m = ref_build_model(rcfg), build_model(cfg)
    batch = TokenStream(cfg.vocab_size, S, B, seed=1).next_batch()
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    for dt in (jnp.float32, jnp.bfloat16):
        ref = jax.device_get(jax.jit(lambda k: rm.init(k, dt))(
            jax.random.key(0)))
        params = params_from_reference(ref, cfg, device="cpu")
        r_logits = np.asarray(jax.jit(lambda p, b: rm.forward_train(p, b)[0])(
            ref, batch))
        logits, _ = m.forward_train(params, tbatch)
        if dt == jnp.float32:
            np.testing.assert_allclose(logits.numpy(), r_logits, rtol=1e-4,
                                       atol=1e-5 * np.abs(r_logits).max())
            continue
        assert (np.abs(logits.numpy() - r_logits).max()
                <= 2e-2 * np.abs(r_logits).max())
        r_loss, _ = jax.jit(lambda p, b: ref_lm_loss(rm, p, b))(ref, batch)
        loss, _ = lm_loss(m, params, tbatch)
        np.testing.assert_allclose(float(loss), float(r_loss), rtol=2e-2,
                                   atol=2e-2)


def test_grads_match_reference_bf16(setup):
    ref = setup["ref"][jnp.bfloat16]
    params = params_from_reference(ref, setup["cfg"], device="cpu")
    got = _port_grads(setup["m"], params, setup["tbatch"])
    want = _ref_grads(setup["rm"], ref, setup["batch"])
    for (key, _), g, r in zip(tree_flatten_with_path(params), got, want):
        rel = np.linalg.norm(g - r) / np.linalg.norm(r)
        assert rel < 3e-2, (key, rel)


def test_grads_match_reference_f32(setup):
    ref = setup["ref"][jnp.float32]
    params = params_from_reference(ref, setup["cfg"], device="cpu")
    got = _port_grads(setup["m"], params, setup["tbatch"])
    want = _ref_grads(setup["rm"], ref, setup["batch"])
    for (key, _), g, r in zip(tree_flatten_with_path(params), got, want):
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max(), err_msg=key)


def test_remat_gives_the_same_grads(setup):
    params = params_from_reference(setup["ref"][jnp.bfloat16], device="cpu")
    m = setup["m"]

    def grads(remat):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, _ = lm_loss(m, tree_unflatten(params, live), setup["tbatch"],
                          remat=remat)
        return torch.autograd.grad(loss, live)

    for a, b in zip(grads(False), grads(True)):
        assert torch.equal(a, b)


# -- flash attention, RoPE and the norm ---------------------------------

def _attn_data(Bq, Sq, H, KV, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Bq, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, KV, D)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, KV, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32)[None], (Bq, Sq))
    return q, k, v, np.ascontiguousarray(pos)


def _dense(q, k, v, pos, window, scale, softcap=None):
    m = torch.ones((q.shape[0], 1, q.shape[1], k.shape[1]), dtype=torch.bool)
    m &= (pos[:, :, None] >= pos[:, None, :])[:, None]
    if window is not None:
        m &= (pos[:, :, None] - window < pos[:, None, :])[:, None]
    return L._attend_dense(q, k, v, m, scale, softcap)


@pytest.mark.parametrize("Bq,Sq,H,KV,D,qc,kc", [
    (1, 16, 4, 4, 8, 4, 4),
    (2, 37, 8, 4, 16, 16, 8),      # ragged + GQA
    (1, 64, 6, 2, 32, 64, 64),     # single chunk
    (3, 20, 4, 1, 8, 7, 5),        # MQA + non-divisible chunks
])
def test_flash_forward_matches_dense_and_reference(Bq, Sq, H, KV, D, qc, kc):
    q, k, v, pos = _attn_data(Bq, Sq, H, KV, D, seed=Sq)
    t = [torch.tensor(a) for a in (q, k, v, pos)]
    dense = _dense(*t, None, D ** -0.5)
    flash = L.flash_attention(t[0], t[1], t[2], q_pos=t[3], kv_pos=t[3],
                              scale=D ** -0.5, q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(flash.numpy(), dense.numpy(), rtol=1e-5,
                               atol=1e-5)
    ref = RL.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             q_pos=jnp.asarray(pos), kv_pos=jnp.asarray(pos),
                             causal=True, window=None, scale=D ** -0.5,
                             q_chunk=qc, kv_chunk=kc)
    np.testing.assert_allclose(flash.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("window,softcap", [(None, None), (7, 5.0)])
def test_flash_grads_match_dense(window, softcap):
    q, k, v, pos = _attn_data(2, 33, 8, 4, 16, seed=1)
    ct = torch.tensor(np.random.default_rng(2).standard_normal(
        (2, 33, 8, 16)).astype(np.float32))

    def grads(fn):
        qkv = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        (fn(*qkv) * ct).sum().backward()
        return [a.grad for a in qkv]

    p = torch.tensor(pos)
    g1 = grads(lambda q_, k_, v_: _dense(q_, k_, v_, p, window, 0.25,
                                         softcap))
    g2 = grads(lambda q_, k_, v_: L.flash_attention(
        q_, k_, v_, q_pos=p, kv_pos=p, window=window, scale=0.25,
        q_chunk=8, kv_chunk=8, softcap=softcap))
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_flash_keeps_no_score_matrix():
    """The forward saves q, k, v, the positions, the f32 output and the
    row log-sum-exp: O(S), no (S, S) block."""
    q, k, v, pos = _attn_data(1, 64, 4, 2, 8, seed=3)
    qkv = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    p = torch.tensor(pos)
    out = L.flash_attention(*qkv, q_pos=p, kv_pos=p, scale=0.3, q_chunk=16,
                            kv_chunk=16)
    sizes = [t.numel() for t in out.grad_fn.saved_tensors]
    assert max(sizes) <= 64 * 4 * 8 and len(sizes) == 7


@pytest.mark.parametrize("style,frac", [("full", 1.0), ("partial", 0.5),
                                        ("2d", 0.5), ("mrope", 1.0)])
def test_rope_and_norm_match_reference(style, frac):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = np.ascontiguousarray(np.broadcast_to(
        np.arange(9, dtype=np.int32)[None] * 37, (2, 9)))
    rc = dataclasses.replace(ref_get_config(ARCH), rope_style=style,
                             rope_frac=frac)
    pc = dataclasses.replace(get_config(ARCH), rope_style=style,
                             rope_frac=frac)
    got = L.apply_rope(torch.tensor(x), torch.tensor(pos), pc)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), rc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    h = rng.standard_normal((3, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    for kind in ("rmsnorm", "layernorm"):
        got = L.apply_norm({"scale": torch.tensor(scale)}, torch.tensor(h),
                           kind)
        want = RL.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(h),
                             kind)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
