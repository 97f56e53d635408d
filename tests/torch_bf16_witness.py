"""Two bf16 measurements behind the recurrent families' numerics, on the
CPU against the live reference (a script, not collected):

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
"""
import dataclasses

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


if __name__ == "__main__":
    spellings()
    drift()
