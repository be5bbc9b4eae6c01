"""Load the JAX package's flax ``variables`` into the port's LM.

``from_flax(variables)`` takes the per-node variables of
``adapt_tpu.models.transformer_lm`` (nested dicts of numpy arrays — pass
``jax.device_get(variables)``, or anything ``np.asarray`` reads) and
returns a ``state_dict`` for ``adapt_tpu_torch.models.transformer_lm.
TransformerLM``; ``lm.load_state_dict(sd)`` then copies it onto the
model's device and dtypes, and the port computes the same function.

Mapping (flax -> torch):

- ``Dense`` kernels are ``(in, out)``: transposed into ``nn.Linear``'s
  ``(out, in)``.
- The MHA ``qkv`` DenseGeneral kernel ``(dim, 3, heads, hd)`` flattens to
  ``(dim, 3*heads*hd)`` (the port splits it with ``view(..., 3, heads,
  hd)``, the order of ``moveaxis(·, 2, 0)``); the GQA ``q`` kernel
  ``(dim, heads, hd)`` and ``kv`` kernel ``(dim, 2, kv_h, hd)`` likewise.
- ``LayerNorm`` scale/bias, ``Embed.embedding`` and ``pos_embed`` (present
  only with learned positions) keep their shapes.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _dense(out: dict, prefix: str, p: dict) -> None:
    kernel = np.asarray(p["kernel"], np.float32)
    out[f"{prefix}.weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
    out[f"{prefix}.bias"] = _t(np.asarray(p["bias"]).reshape(-1))


def _norm(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.scale"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def from_flax(variables) -> dict[str, torch.Tensor]:
    """flax LM variables -> the port's ``state_dict`` (f32 CPU tensors)."""
    sd: dict[str, torch.Tensor] = {}
    embed = variables["embed"]["params"]
    sd["embed.tok.weight"] = _t(embed["tok"]["embedding"])
    if "pos_embed" in embed:
        sd["embed.pos_embed"] = _t(embed["pos_embed"])
    head = variables["head"]["params"]
    _norm(sd, "head.ln", head["ln"])
    _dense(sd, "head.logits", head["logits"])
    blocks = sorted(
        (k for k in variables if k.startswith("decoder_block_")),
        key=lambda k: int(k.rsplit("_", 1)[1]),
    )
    for name in blocks:
        p = variables[name]["params"]
        if "moe" in p:
            raise NotImplementedError("MoE blocks are not ported yet")
        _norm(sd, f"{name}.ln1", p["ln1"])
        _norm(sd, f"{name}.ln2", p["ln2"])
        _dense(sd, f"{name}.mlp_in", p["mlp_in"])
        _dense(sd, f"{name}.mlp_out", p["mlp_out"])
        attn = p["attn"]
        for proj in ("qkv", "q", "kv", "out"):
            if proj in attn:
                _dense(sd, f"{name}.attn.{proj}", attn[proj])
    return sd
