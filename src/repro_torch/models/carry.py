"""Carry a model's parameters, and its decode states, between the
reference and the port.

The reference's param tree, as ``jax.device_get(model.init(key))`` gives
it, is a nested dict (and list) of numpy arrays; its bf16 leaves have
``ml_dtypes``' bfloat16 dtype, which PyTorch cannot read directly, so
they cross as their 16-bit patterns. Both directions keep every bit and
the tree's structure (the ``prologue`` list and the stacked ``stack``
slots, or whisper's ``enc_layers`` and ``dec_layers`` lists, included),
so leaves, their order and their checkpoint keys are
the same in both packages (an MoE arch's ``prologue`` layers and MTP
head, ``mtp``, too).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.models.transformer import (_first_k_dense, _period,
                                            layer_plan)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import tree_map


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One leaf: a numpy array (bf16 by its bit pattern) as a tensor of
    the same dtype on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One leaf back: bf16 as an ``ml_dtypes.bfloat16`` array (the
    package the reference's arrays come with)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _check_tree(np_tree, cfg: ModelConfig) -> None:
    """The reference's leaves for ``cfg``: the embedding's shape, the
    prologue's length, every stacked slot's depth and the MTP head where
    the config has one (whisper: the encoder's and decoder's layer
    counts)."""
    want = (padded_vocab(cfg), cfg.d_model)
    got = tuple(np.shape(np_tree["embed"]))
    if got != want:
        raise ValueError(f"params_from_reference: embed is {got}, "
                         f"{cfg.name} has {want}")
    if cfg.family == "audio":
        counts = {"enc_layers": cfg.encdec.num_layers,
                  "dec_layers": cfg.num_layers}
        for key, n in counts.items():
            if len(np_tree[key]) != n:
                raise ValueError(f"params_from_reference: {key} holds "
                                 f"{len(np_tree[key])} layers, {cfg.name} "
                                 f"has {n}")
        return
    k_dense = _first_k_dense(cfg)
    if len(np_tree["prologue"]) != k_dense:
        raise ValueError(f"params_from_reference: the prologue holds "
                         f"{len(np_tree['prologue'])} layers, {cfg.name} "
                         f"has {k_dense}")
    if ("mtp" in np_tree) != (cfg.mtp_depth > 0):
        raise ValueError(f"params_from_reference: the tree "
                         f"{'has' if 'mtp' in np_tree else 'lacks'} an MTP "
                         f"head, {cfg.name}'s mtp_depth is {cfg.mtp_depth}")
    n_cycles = (len(layer_plan(cfg)) - k_dense) // _period(cfg)
    for slot in np_tree["stack"]:
        lead = np.shape(slot["mixer_norm"]["scale"])[0]
        if lead != n_cycles:
            raise ValueError(f"params_from_reference: a slot stacks "
                             f"{lead} layers, {cfg.name} has {n_cycles}")


def params_from_reference(np_tree, cfg: ModelConfig | None = None, *,
                          device=None):
    """The reference's param tree (numpy leaves) as the port's tensors on
    ``device`` (the card by default). With ``cfg``, the tree must hold
    the reference's leaves for it (``_check_tree``)."""
    dev = resolve_device(device)
    if cfg is not None:
        _check_tree(np_tree, cfg)
    return tree_map(lambda a: tensor_from_numpy(a, dev), np_tree)


def params_to_reference(params):
    """The inverse of ``params_from_reference``: numpy leaves, bf16 as
    ``ml_dtypes.bfloat16``."""
    return tree_map(tensor_to_numpy, params)


def states_from_reference(np_states, device=None) -> list:
    """The reference's per-layer decode states (a list of dicts of numpy
    arrays, as ``jax.device_get`` gives them: ``{k, v, pos_abs}`` for an
    attention layer, ``{c, kr, pos_abs}`` for an MLA layer, ``{h, conv}``
    for an RG-LRU or SSD layer, ``{self:
    {k, v, pos_abs}, cross_k, cross_v}`` for a whisper decoder layer) as
    the port's tensors on ``device`` (the card by default), every bit
    kept."""
    dev = resolve_device(device)
    return [tree_map(lambda a: tensor_from_numpy(a, dev), st)
            for st in np_states]


def states_to_reference(states) -> list:
    """The inverse of ``states_from_reference``: numpy leaves, bf16 as
    ``ml_dtypes.bfloat16``."""
    return [tree_map(tensor_to_numpy, st) for st in states]
