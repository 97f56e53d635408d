"""The port's serving path against the reference on the CPU, at
``.reduced()`` of the five ported archs (tinyllama-1.1b; nemotron-4-15b:
partial RoPE, relu2, layernorm; command-r-35b: parallel block, tied
embeddings; mamba2-2.7b: SSD layers with ``{h, conv}`` states;
recurrentgemma-9b: RG-LRU layers and local attention in a ring buffer),
with the reference's params carried across (``models.carry``): decode
states, prefill, decode steps against the states, greedy generation,
the ring buffer under a sliding window, the launcher and the example,
and the API repairs of the local-updates round and the loss.

The reference's prefill and decode steps run once per (arch, dtype), in
a module-scoped fixture; each decode step feeds the same seeded tokens
to both packages.

Tolerances: f32 logits at rtol 1e-4 with atol 1e-5 of the largest logit
(sum orders only, as ``test_torch_transformer.py``'s f32 grads); bf16
logits under ``test_torch_transformer.py``'s rule, 2e-2 of the largest
logit everywhere and, over a run's prefill and decode steps, no more
elements outside rtol = atol = 2e-2 than twice the reference's own
op-by-op run (``jax.disable_jit``) has; decode
against teacher forcing at the reference's own 0.15 in log-softmax
(``tests/test_models_smoke.py``); greedy ids compared in f32 where the
top-two gap exceeds ten times the f32 tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MLAConfig as RMLAConfig
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import transformer as RT
from repro.models.registry import states_max_len as ref_states_max_len
from repro.serve import greedy_generate as ref_greedy_generate
from repro.train.loss import lm_loss as ref_lm_loss
from repro_torch.configs import MLAConfig, get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.models import build_model
from repro_torch.models import transformer as T
from repro_torch.models.carry import (params_from_reference,
                                      states_from_reference,
                                      states_to_reference)
from repro_torch.models.registry import states_max_len
from repro_torch.optim import AdamWConfig, LocalUpdatesConfig, adamw_init
from repro_torch.optim import local_updates_round
from repro_torch.serve import greedy_generate, make_serve_step
from repro_torch.train import make_train_step
from repro_torch.train.loss import lm_loss
from repro_torch.utils.trees import tree_leaves

# the decoder-only archs of the dense, SSM and hybrid families; the vlm
# and audio ones are held in tests/test_torch_vlm_audio.py
ARCHS = ("tinyllama-1.1b", "nemotron-4-15b", "command-r-35b", "mamba2-2.7b",
         "recurrentgemma-9b")
B, S, N = 2, 16, 4          # batch, prompt, decode steps fed seeded tokens
TF_TOL = 0.15               # tests/test_models_smoke.py's decode bound
GREEDY_GAP = 1e-3           # of the largest logit: 10x the f32 rtol of 1e-4
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(
        0, vocab, shape).astype(np.int32)


def _positions(t):
    return np.full((B, 1), t, np.int32)


def _ref_serve(rm, params, prompts, toks, cache_dtype, *, eager=False):
    """The reference's prefill and N decode steps (jitted, or op by op
    under ``jax.disable_jit``): every logits array and the states after
    the prefill, after the first step and at the end, as numpy."""
    prefill = lambda p, b, st: rm.prefill(p, b, st)     # noqa: E731
    step = lambda p, b, st: rm.decode_step(p, b, st)    # noqa: E731
    if not eager:
        prefill, step = jax.jit(prefill), jax.jit(step)
    with jax.disable_jit(eager):
        st = rm.init_states(params, B, S + N, dtype=cache_dtype)
        logits, st = prefill(params, {"tokens": jnp.asarray(prompts)}, st)
        out = {"prefill": np.asarray(logits), "steps": [],
               "states_prefill": jax.device_get(st)}
        for t in range(N):
            logits, st = step(params, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                       "positions": jnp.asarray(
                                           _positions(S + t))}, st)
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
    return out


@pytest.fixture(scope="module")
def runs():
    """Per arch: both packages' models, the reference's params in bf16
    and f32, the prompts and step tokens, and the reference's runs (bf16
    also op by op)."""
    out = {}
    for arch in ARCHS:
        rcfg = ref_get_config(arch).reduced()
        cfg = get_config(arch).reduced()
        rm, m = ref_build_model(rcfg), build_model(cfg)
        prompts = _tokens(cfg.vocab_size, (B, S), 1)
        toks = _tokens(cfg.vocab_size, (B, N), 2)
        a = dict(rm=rm, m=m, cfg=cfg, prompts=prompts, toks=toks, ref={},
                 params={})
        for name, (jdt, _) in DTYPES.items():
            p = jax.device_get(jax.jit(lambda k, dt=jdt: rm.init(k, dt))(
                jax.random.key(0)))
            a["params"][name] = p
            a["ref"][name] = _ref_serve(rm, p, prompts, toks, jdt)
        a["ref"]["bf16_eager"] = _ref_serve(rm, a["params"]["bf16"], prompts,
                                            toks, jnp.bfloat16, eager=True)
        out[arch] = a
    return out


def _port_params(a, dtype):
    return params_from_reference(a["params"][dtype], a["cfg"], device="cpu")


def _outside(a, b, tol=2e-2) -> int:
    """Elements of ``a`` outside rtol = atol = ``tol`` of ``b``."""
    return int(np.sum(np.abs(a - b) > tol + tol * np.abs(b)))


def _logsm(x):
    return torch.log_softmax(torch.as_tensor(x, dtype=torch.float32),
                             -1).numpy()


# -- decode states -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("window", [None, 16])
def test_init_states_has_the_reference_shapes(arch, window):
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(),
                               sliding_window=window)
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              sliding_window=window)
    want = RT.init_states(rcfg, 3, 40, jnp.bfloat16)
    with torch.device("cpu"):
        got = T.init_states(cfg, 3, 40)
    assert len(got) == len(want) == cfg.num_layers
    for (mixer, _), g, w in zip(T.layer_plan(cfg), got, want):
        want_keys = (["h", "conv"] if mixer in ("rglru", "ssd")
                     else ["k", "pos_abs", "v"])
        assert sorted(g) == sorted(w) == sorted(want_keys)
        for key in g:
            assert tuple(g[key].shape) == w[key].shape
            assert str(g[key].dtype).split(".")[-1] == str(w[key].dtype)
        if "pos_abs" in g:
            assert bool((g["pos_abs"] == -1).all())
            assert not g["k"].any() and not g["v"].any()
        else:
            assert not g["h"].any() and not g["conv"].any()
    assert states_max_len(got) == ref_states_max_len(want)
    assert states_max_len(got) == {"mamba2-2.7b": 0,
                                   "recurrentgemma-9b": 40}.get(
        arch, 40 if window is None else 16)
    assert states_max_len([]) == 0


def test_init_states_refuses_an_unported_mixer():
    """An MLA config's attention layers get the latent cache (the
    reference's shapes and dtypes); an unknown mixer is refused."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              mla=MLAConfig())
    rcfg = dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                               mla=RMLAConfig())
    want = RT.init_states(rcfg, 1, 8, jnp.bfloat16)
    got = T.init_states(cfg, 1, 8)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["c", "kr", "pos_abs"]
        for key in g:
            assert tuple(g[key].shape) == w[key].shape
            assert str(g[key].dtype).split(".")[-1] == str(w[key].dtype)
    bad = dataclasses.replace(cfg, mla=None, block_pattern=("conv",))
    with pytest.raises(ValueError, match="unknown mixer"):
        T.init_states(bad, 1, 8)


# -- prefill ---------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_equals_forward_train_and_its_last_row(runs, arch):
    a = runs[arch]
    m, params = a["m"], _port_params(a, "bf16")
    batch = {"tokens": torch.tensor(a["prompts"])}
    with torch.inference_mode():
        train, _ = m.forward_train(params, batch)
        st = m.init_states(params, B, S + N)
        full, st2 = m.prefill(params, batch, st)
        last, _ = m.prefill(params, batch, m.init_states(params, B, S + N),
                            last_logits_only=True)
    assert st2 is not None and all(x is y for x, y in zip(st2, st))
    assert torch.equal(full, train)
    assert last.shape == (B, 1, full.shape[-1])
    assert torch.equal(last[:, 0], full[:, -1])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_prefill_and_decode_logits_match_reference(runs, arch, dtype):
    a = runs[arch]
    ref = a["ref"][dtype]
    got = _port_serve(a["m"], _port_params(a, dtype), a["prompts"],
                      a["toks"], DTYPES[dtype][1])
    pairs = [(got["prefill"], ref["prefill"])] + list(
        zip(got["steps"], ref["steps"]))
    if dtype == "f32":
        for g, r in pairs:
            np.testing.assert_allclose(g, r, rtol=1e-4,
                                       atol=1e-5 * np.abs(r).max())
        return
    # the misses are counted over the whole run: a step's 1,024 logits
    # hold a handful, too few to compare one step at a time
    eager = [a["ref"]["bf16_eager"]["prefill"]] + a["ref"]["bf16_eager"][
        "steps"]
    for g, r in pairs:
        assert np.abs(g - r).max() <= 2e-2 * np.abs(r).max()
    assert sum(_outside(g, r) for g, r in pairs) <= 2 * sum(
        _outside(e, r) for (_, r), e in zip(pairs, eager))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_from_the_reference_cache(runs, arch):
    """One step in the port from the reference's own prefilled states
    (f32) gives the reference's logits and its new states; the carried
    cache slots, ``pos_abs`` and the conv tail's shifted rows bit for
    bit."""
    a = runs[arch]
    ref = a["ref"]["f32"]
    params = _port_params(a, "f32")
    st = states_from_reference(ref["states_prefill"], device="cpu")
    with torch.inference_mode():
        logits, st = a["m"].decode_step(
            params, {"tokens": torch.tensor(a["toks"][:, :1]),
                     "positions": torch.tensor(_positions(S))}, st)
    r = ref["steps"][0]
    np.testing.assert_allclose(logits.numpy(), r, rtol=1e-4,
                               atol=1e-5 * np.abs(r).max())
    got = states_to_reference(st)
    for g, w, before in zip(got, ref["states_step1"], ref["states_prefill"]):
        assert sorted(g) == sorted(w)
        if "conv" in g:
            np.testing.assert_array_equal(g["conv"][:, :-1],
                                          before["conv"][:, 1:])
            for key in ("h", "conv"):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4,
                                           atol=1e-5)
            continue
        np.testing.assert_array_equal(g["pos_abs"], w["pos_abs"])
        for key in ("k", "v"):
            np.testing.assert_array_equal(g[key][:, :S], before[key][:, :S])
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_states_carry_round_trip_is_bit_for_bit(runs, arch):
    ref = runs[arch]["ref"]["bf16"]["states_end"]
    back = states_to_reference(states_from_reference(ref, device="cpu"))
    for g, w in zip(back, ref):
        for key in w:
            assert g[key].dtype == w[key].dtype
            assert np.array_equal(g[key].view(np.uint8),
                                  np.asarray(w[key]).view(np.uint8))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(runs, arch):
    """Each decode step's log-softmax within 0.15 of the full forward
    over the prompt and the tokens fed so far (bf16)."""
    a = runs[arch]
    params = _port_params(a, "bf16")
    got = _port_serve(a["m"], params, a["prompts"], a["toks"],
                      torch.bfloat16)
    seq = torch.tensor(np.concatenate([a["prompts"], a["toks"]], 1))
    with torch.inference_mode():
        tf, _ = a["m"].forward_train(params, {"tokens": seq})
    tf = _logsm(tf)
    assert np.abs(_logsm(got["prefill"][:, -1]) - tf[:, S - 1]).max() < TF_TOL
    for t, lg in enumerate(got["steps"]):
        assert np.abs(_logsm(lg[:, 0]) - tf[:, S + t]).max() < TF_TOL


# -- greedy generation -----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_ids_match_reference(runs, arch):
    """f32 params (the default bf16 caches): equal ids up to the first
    position of each row where the reference's teacher-forced top-two
    gap is below ``GREEDY_GAP`` of its largest logit, ten times the f32
    logits' tolerance. In bf16 the random reduced models' top two lie
    within the bf16 tolerance at nearly every position, so an id
    comparison there would compare almost nothing."""
    a = runs[arch]
    n = 8
    rp = a["params"]["f32"]
    want = np.asarray(ref_greedy_generate(
        a["rm"], rp, jnp.asarray(a["prompts"]), max_new=n))
    got = greedy_generate(a["m"], _port_params(a, "f32"),
                          torch.tensor(a["prompts"]), max_new=n)
    assert got.dtype == torch.int32 and got.shape == (B, n)
    seq = jnp.asarray(np.concatenate([a["prompts"], want[:, :-1]], 1))
    tf = np.asarray(jax.jit(lambda p, b: a["rm"].forward_train(p, b)[0])(
        rp, {"tokens": seq}))[:, S - 1:]
    top2 = np.sort(tf, -1)[..., -2:]
    gap = (top2[..., 1] - top2[..., 0]) / np.abs(tf).max()
    compared = 0
    for b in range(B):
        close = np.flatnonzero(gap[b] < GREEDY_GAP)
        upto = close[0] if close.size else n
        np.testing.assert_array_equal(got[b, :upto].numpy(), want[b, :upto])
        compared += upto
    assert compared >= n        # at least a row's worth of ids compared


def test_greedy_generate_edge_cases(runs):
    a = runs["tinyllama-1.1b"]
    m, params = a["m"], _port_params(a, "bf16")
    prompts = torch.tensor(a["prompts"])
    none = greedy_generate(m, params, prompts, max_new=0)
    assert none.shape == (B, 0) and none.dtype == torch.int32
    assert greedy_generate(m, params, prompts, max_new=-3).shape == (B, 0)
    one = greedy_generate(m, params, prompts, max_new=1)
    with torch.inference_mode():
        logits, _ = m.prefill(params, {"tokens": prompts},
                              m.init_states(params, B, S + 1))
    assert torch.equal(one[:, 0], logits[:, -1].argmax(-1).to(torch.int32))
    step = make_serve_step(m)
    st = m.init_states(params, B, S + 1)
    with torch.inference_mode():
        m.prefill(params, {"tokens": prompts}, st)
        lg, st2 = step(params, st, one, torch.full((B, 1), S,
                                                    dtype=torch.int32))
    assert lg.shape == (B, 1, logits.shape[-1]) and st2 is not None
    assert all(bool((s["pos_abs"] == torch.arange(S + 1)).all())
               for s in st2)


def test_argmax_takes_the_first_maximum():
    from repro_torch.serve.decode import _greedy
    x = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert _greedy(x).tolist() == np.asarray(
        jnp.argmax(jnp.asarray(x.numpy()), -1))[:, None].tolist()


def test_ring_buffer_matches_reference():
    """sliding_window = 16 with a prompt of 24 and 12 new tokens: the
    prefill keeps the last 16 positions, each step overwrites the slot
    ``pos % 16``; logits and every cache slot as the reference's (f32)."""
    arch, W, S_, n = "tinyllama-1.1b", 16, 24, 12
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(),
                               sliding_window=W)
    cfg = dataclasses.replace(get_config(arch).reduced(), sliding_window=W)
    rm, m = ref_build_model(rcfg), build_model(cfg)
    rp = jax.device_get(jax.jit(lambda k: rm.init(k, jnp.float32))(
        jax.random.key(0)))
    params = params_from_reference(rp, cfg, device="cpu")
    prompts = _tokens(cfg.vocab_size, (B, S_), 3)
    toks = _tokens(cfg.vocab_size, (B, n), 4)
    prefill = jax.jit(lambda p, b, st: rm.prefill(p, b, st))
    step = jax.jit(lambda p, b, st: rm.decode_step(p, b, st))
    rst = rm.init_states(rp, B, S_ + n, dtype=jnp.float32)
    st = m.init_states(params, B, S_ + n, dtype=torch.float32)
    assert st[0]["k"].shape[1] == W
    r_lg, rst = prefill(rp, {"tokens": jnp.asarray(prompts)}, rst)
    with torch.inference_mode():
        lg, st = m.prefill(params, {"tokens": torch.tensor(prompts)}, st)
        pairs = [(lg.numpy(), np.asarray(r_lg))]
        for t in range(n):
            b = {"tokens": toks[:, t:t + 1], "positions": _positions(S_ + t)}
            r_lg, rst = step(rp, {k: jnp.asarray(v) for k, v in b.items()},
                             rst)
            lg, st = m.decode_step(params, {k: torch.tensor(v)
                                            for k, v in b.items()}, st)
            pairs.append((lg.numpy(), np.asarray(r_lg)))
    for g, r in pairs:
        np.testing.assert_allclose(g, r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max())
    last = S_ + n - 1
    for g, w in zip(states_to_reference(st), jax.device_get(rst)):
        np.testing.assert_array_equal(g["pos_abs"], w["pos_abs"])
        assert sorted(g["pos_abs"][0]) == list(range(last - W + 1, last + 1))
        for key in ("k", "v"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4, atol=1e-5)


# -- the launcher ------------------------------------------------------------

def test_launch_serve_reduced_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--reduced", "--batch", "2", "--prompt-len", "8",
                "--max-new", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "generated (2, 4)" in out and "on cpu" in out
    for arch in ("mamba2-2.7b", "recurrentgemma-9b"):
        serve.main(["--arch", arch, "--reduced", "--batch", "2",
                    "--prompt-len", "8", "--max-new", "4", "--device",
                    "cpu"])
        assert "generated (2, 4)" in capsys.readouterr().out
    serve.main(["--arch", "deepseek-v3-671b", "--reduced", "--batch", "2",
                "--prompt-len", "8", "--max-new", "4", "--device", "cpu"])
    assert "generated (2, 4)" in capsys.readouterr().out


def test_serve_example_on_the_cpu(capsys):
    """The reference's example serves one arch of each state family."""
    from repro_torch.examples import serve_lm
    serve_lm.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    archs = ("tinyllama-1.1b", "mamba2-2.7b", "recurrentgemma-9b")
    assert len(lines) == len(archs) + 1
    for arch, line in zip(archs, lines):
        assert line.startswith(arch) and "generated 4x12" in line
    assert "all three state families" in lines[-1]


# -- API repairs: the reference's keywords and positions ---------------------

def test_local_updates_round_takes_axis_name_sixth(tmp_path):
    """The sixth parameter is the reference's ``axis_name``: a mesh-axis
    name raises (the port has no mesh), a one-rank process group returns
    what ``None`` does, and ``codec_state`` comes after it."""
    import torch.distributed as tdist
    cfg = get_config("tinyllama-1.1b").reduced()
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    opt_cfg = AdamWConfig(lr=1e-3)
    step = make_train_step(m, opt_cfg)
    ts = TokenStream(cfg.vocab_size, 16, 2, seed=0)
    bs = [ts.next_batch() for _ in range(2)]
    batches = {k: torch.tensor(np.stack([b[k] for b in bs])) for k in bs[0]}
    lc = LocalUpdatesConfig(H=2)
    with pytest.raises(TypeError, match="Queue 1 item 13"):
        local_updates_round(step, params, adamw_init(params, opt_cfg),
                            batches, lc, "data", codec_state=None)
    p1, o1, m1 = local_updates_round(step, params,
                                     adamw_init(params, opt_cfg), batches,
                                     lc, None)
    p2, _, m2, st = local_updates_round(
        step, params, adamw_init(params, opt_cfg), batches, lc,
        codec_state={"r": torch.zeros(3)})
    assert torch.equal(m1["loss"], m2["loss"]) and "r" in st
    tdist.init_process_group("gloo", init_method=f"file://{tmp_path}/g",
                             world_size=1, rank=0)
    try:
        p3, o3, m3 = local_updates_round(
            step, params, adamw_init(params, opt_cfg), batches, lc,
            tdist.group.WORLD)
    finally:
        tdist.destroy_process_group()
    assert torch.equal(m1["loss"], m3["loss"])
    for a, b in zip(tree_leaves((p1, o1)), tree_leaves((p3, o3))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_forward_train_and_lm_loss_take_the_reference_keywords(runs):
    a = runs["nemotron-4-15b"]
    m, params = a["m"], _port_params(a, "f32")
    ts = TokenStream(a["cfg"].vocab_size, S, B, seed=5)
    batch = {k: torch.tensor(v) for k, v in ts.next_batch().items()}
    base, _ = m.forward_train(params, batch)
    unrolled, _ = m.forward_train(params, batch, unroll=True)
    assert torch.equal(base, unrolled)
    l0, _ = lm_loss(m, params, batch)
    l1, met = lm_loss(m, params, batch, unroll=True, mtp_coef=0.3)
    assert torch.equal(l0, l1)
    r_loss, _ = ref_lm_loss(a["rm"], a["params"]["f32"],
                            {k: jnp.asarray(v.numpy())
                             for k, v in batch.items()},
                            unroll=True, mtp_coef=0.3)
    np.testing.assert_allclose(float(l1), float(r_loss), rtol=1e-5)
    # with an MTP head (nemotron's reduced config given mtp_depth = 1):
    # the loss and its MTP term are the reference's
    rm = ref_build_model(dataclasses.replace(a["rm"].cfg, mtp_depth=1))
    rp = jax.device_get(jax.jit(lambda k: rm.init(k, jnp.float32))(
        jax.random.key(0)))
    mtp = build_model(dataclasses.replace(a["cfg"], mtp_depth=1))
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    r_loss, r_met = ref_lm_loss(rm, rp, jb, mtp_coef=0.3)
    l2, met = lm_loss(mtp, params_from_reference(rp, mtp.cfg, device="cpu"),
                      batch, mtp_coef=0.3)
    np.testing.assert_allclose(float(l2), float(r_loss), rtol=1e-4)
    np.testing.assert_allclose(float(met["mtp_loss"]),
                               float(r_met["mtp_loss"]), rtol=1e-4)
