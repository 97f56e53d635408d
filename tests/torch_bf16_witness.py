"""Three bf16 measurements behind the recurrent and MoE families'
numerics, on the CPU against the live reference (a script, not
collected):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_bf16_witness.py

1. The spelling of the activations. At ``.reduced()`` in bf16 on the
   reference's carried params (two seeded batches of 2 x 64 tokens), how
   many logits fall outside rtol = atol = 2e-2 of the jitted reference's
   (the count rule of ``tests/test_torch_serve.py``), for the reference's
   own op-by-op run and for the port with each spelling: the sigmoid op
   by op (``layers._sigmoid``) or ``torch.sigmoid``; gelu as jax writes
   it (``layers._gelu``) or ``F.gelu(approximate="tanh")``.
2. The bf16 drift of the decode against teacher forcing with depth:
   mamba2-2.7b at full width cut to 16 layers, B 1, a prompt of 256 and
   16 greedy tokens, in the reference and in the port (each on its own
   random bf16 params): the largest log-softmax difference at the
   prompt's last row and at each decoded position.
3. The same drift for deepseek-v3 with no token dropped, at its MLA
   widths and its router's 256 experts top 8 with a narrower d_model and
   experts (``_deepseek_at``: 5 layers, d_model 1024, experts of 64), B
   1, a prompt of 64 and 32 greedy tokens, on the same params: the
   reference, and the port through ``chip_smoke.py``'s
   ``no_drop_teacher_forcing`` (the positions whose experts change, in
   the prompt and among the decoded ones), again with its decode steps'
   MLA in the prefill's form (``chip_smoke.mla_decode_rebuilt``).
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.carry import params_from_reference

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402  (the repo root's; phase 11's probes)


def _outside(a, b, tol=2e-2) -> int:
    return int(np.sum(np.abs(a - b) > tol + tol * np.abs(b)))


def spellings() -> None:
    sig, gelu = L._sigmoid, L._ACTS["gelu"]
    variants = {
        "as shipped": (sig, gelu),
        "torch.sigmoid": (torch.sigmoid, gelu),
        "F.gelu(tanh)": (sig, lambda x: F.gelu(x, approximate="tanh")),
    }
    for arch in ("mamba2-2.7b", "recurrentgemma-9b"):
        rcfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
        rm, m = ref_build_model(rcfg), build_model(cfg)
        rp = jax.device_get(jax.jit(lambda k: rm.init(k, jnp.bfloat16))(
            jax.random.key(0)))
        params = params_from_reference(rp, cfg, device="cpu")
        for seed in (0, 1):
            toks = np.random.default_rng(seed).integers(
                0, cfg.vocab_size, (2, 64)).astype(np.int32)
            batch = {"tokens": jnp.asarray(toks)}
            jit = np.asarray(jax.jit(lambda p, b: rm.forward_train(p, b)[0])(
                rp, batch))
            with jax.disable_jit():
                eager = np.asarray(rm.forward_train(rp, batch)[0])
            row = {"reference op by op": _outside(eager, jit)}
            for name, (s, g) in variants.items():
                L._sigmoid, L._ACTS["gelu"] = s, g
                with torch.inference_mode():
                    got = m.forward_train(
                        params, {"tokens": torch.tensor(toks)})[0].numpy()
                row[name] = _outside(got, jit)
            L._sigmoid, L._ACTS["gelu"] = sig, gelu
            print(f"{arch} seed {seed}: logits outside 2e-2 of the jitted "
                  f"reference's, of {jit.size}: {row}")


def _drift(rows, tf, S):
    got = torch.log_softmax(torch.as_tensor(np.stack(rows, 1),
                                            dtype=torch.float32), -1)
    want = torch.log_softmax(torch.as_tensor(tf, dtype=torch.float32)
                             [:, S - 1:], -1)
    return [round(float(x), 4) for x in (got - want).abs().amax(dim=(0, 2))]


def drift(layers=16, S=256, n=16) -> None:
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), num_layers=layers)
    rcfg = dataclasses.replace(ref_get_config("mamba2-2.7b"),
                               num_layers=layers)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32)
    rm = ref_build_model(rcfg)
    rp = jax.jit(lambda k: rm.init(k, jnp.bfloat16))(jax.random.key(0))
    lg, st = jax.jit(rm.prefill)(rp, {"tokens": jnp.asarray(prompts)},
                                 rm.init_states(rp, 1, S + n))
    step = jax.jit(rm.decode_step)
    rows, ids = [np.asarray(lg[:, -1], np.float32)], []
    for t in range(n):
        ids.append(rows[-1].argmax(-1).astype(np.int32)[:, None])
        lg, st = step(rp, {"tokens": jnp.asarray(ids[-1]),
                           "positions": jnp.full((1, 1), S + t, jnp.int32)},
                      st)
        rows.append(np.asarray(lg[:, 0], np.float32))
    tf = jax.jit(rm.forward_train)(rp, {"tokens": jnp.asarray(
        np.concatenate([prompts] + ids, 1))})[0]
    print(f"reference, mamba2 at {layers} layers:",
          _drift(rows, np.asarray(tf, np.float32), S))
    del rp, st, tf
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    with torch.inference_mode():
        lg, st = m.prefill(params, {"tokens": torch.tensor(prompts)},
                           m.init_states(params, 1, S + n))
        rows, ids = [lg[:, -1].numpy()], []
        for t in range(n):
            ids.append(torch.tensor(rows[-1].argmax(-1).astype(np.int32)
                                    [:, None]))
            lg, st = m.decode_step(params, {
                "tokens": ids[-1],
                "positions": torch.full((1, 1), S + t, dtype=torch.int32)},
                st)
            rows.append(lg[:, 0].numpy())
        tf, _ = m.forward_train(params, {"tokens": torch.cat(
            [torch.tensor(prompts)] + ids, 1)})
    print(f"port, mamba2 at {layers} layers:", _drift(rows, tf.numpy(), S))


def _deepseek_at(cfg, layers, d_model, experts, d_expert):
    """deepseek-v3 at its MLA widths (128 heads, q_lora 1536, kv_lora 512,
    128/64 q-k split, v 128) and its router's top 8, with a narrower
    d_model, dense FFN and experts, every token kept (capacity_factor =
    num_experts, as a decode step keeps them)."""
    return dataclasses.replace(
        cfg, num_layers=layers, d_model=d_model, d_ff=2 * d_model,
        moe=dataclasses.replace(cfg.moe, num_experts=experts,
                                d_expert=d_expert,
                                capacity_factor=float(experts)))


def mla_drift(layers=5, d_model=1024, experts=256, d_expert=64, S=64,
              n=32) -> None:
    """3. deepseek-v3's bf16 decode against teacher forcing without drops,
    B 1, at ``_deepseek_at``'s widths: the reference and the port on the
    same (carried) params; the largest log-softmax difference at the
    prompt's last row and at each decoded position."""
    rcfg = _deepseek_at(ref_get_config("deepseek-v3-671b"), layers, d_model,
                        experts, d_expert)
    cfg = _deepseek_at(get_config("deepseek-v3-671b"), layers, d_model,
                       experts, d_expert)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32)
    rm = ref_build_model(rcfg)
    rp = jax.device_get(jax.jit(lambda k: rm.init(k, jnp.bfloat16))(
        jax.random.key(0)))
    lg, st = jax.jit(rm.prefill)(rp, {"tokens": jnp.asarray(prompts)},
                                 rm.init_states(rp, 1, S + n))
    step = jax.jit(rm.decode_step)
    rows, ids = [np.asarray(lg[:, -1], np.float32)], []
    for t in range(n - 1):
        ids.append(rows[-1].argmax(-1).astype(np.int32)[:, None])
        lg, st = step(rp, {"tokens": jnp.asarray(ids[-1]),
                           "positions": jnp.full((1, 1), S + t, jnp.int32)},
                      st)
        rows.append(np.asarray(lg[:, 0], np.float32))
    ids.append(rows[-1].argmax(-1).astype(np.int32)[:, None])
    tf = jax.jit(rm.forward_train)(rp, {"tokens": jnp.asarray(
        np.concatenate([prompts] + ids[:-1], 1))})[0]
    print(f"reference, deepseek-v3 at {layers} layers, d_model {d_model}, "
          f"{experts} experts of {d_expert}:",
          _drift(rows, np.asarray(tf, np.float32), S))
    del st, tf
    params = params_from_reference(rp, cfg, device="cpu")
    del rp
    # the port through phase 11's own no-drop teacher forcing, and again
    # with its decode steps' MLA in the prefill's form
    held = chip_smoke.no_drop_teacher_forcing(
        torch, cfg, params, torch.tensor(prompts), n, 0.15, probe_mla=True)
    probe = held["mla_decode_rebuilt"]
    print(f"port, deepseek-v3 at {layers} layers, d_model {d_model}, "
          f"{experts} experts of {d_expert}:",
          [round(x, 4) for x in held["err_by_position"]],
          "experts changed:", held["expert_flips"])
    print("port, its decode's MLA rebuilt in bf16 as the prefill's:",
          [round(x, 4) for x in probe["err_by_position"]],
          "experts changed:", probe["expert_flips"])

if __name__ == "__main__":
    spellings()
    drift()
    mla_drift()
