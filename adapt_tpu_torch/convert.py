"""Load the JAX package's flax ``variables`` into the port's LM, ViT and CNNs.

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
- A blockwise-int8 leaf (the JAX package's ``ops.quantize.QuantizedTensor``,
  as ``quantize_params`` leaves a speculative draft's matrices) is given as
  the numpy 4-tuple ``(values, scales, shape, dtype)``: :func:`quantized_leaf`
  carries it into the port's ``QuantizedTensor``, and :func:`from_flax`
  dequantizes it with the port's own ``dequantize`` before mapping — so the
  very int8 payload JAX produced loads as the draft's weights.

``cnn_from_flax(variables)`` does the same for the JAX package's ResNets
and EfficientNets (``adapt_tpu.models.resnet`` / ``efficientnet``: every
node's ``params`` and ``batch_stats``) and the port's CNN ``LayerGraph``:
conv kernels are HWIO and become torch's OIHW (a depthwise kernel
``(k, k, 1, C)`` becomes ``(C, 1, k, k)``); BatchNorm ``scale`` / ``bias``
(parameters) and ``mean`` / ``var`` (``batch_stats``, buffers in the port)
keep their names; the SE block's two 1x1 convs carry their biases, and the
classifier's Dense its bias. A ``ConvBN``'s flax children ``ConvBN_k``
map to the port's ``conv0``, ``conv1``, ``conv2`` (bottleneck branch),
``conv`` (stem, projection) or ``expand`` / ``depthwise`` / ``project``
(MBConv branch, in the order flax created them).

``shard_state_dict(sd, mesh, rules)`` cuts a converted state dict onto a
tensor-parallel mesh by a rule set (``parallel/sharding``): shard ``i`` of
every tensor is the converted piece of the JAX leaf's
``addressable_shards[i]`` under the JAX package's rules.

``vit_from_flax(variables)`` does the same for ``adapt_tpu.models.vit``'s
per-node variables and the port's ViT ``LayerGraph`` (keys
``layers.<node>.<param>``): the patch ``Conv_0`` kernel is HWIO and becomes
torch's OIHW; ``cls`` and ``pos_embed`` keep their shapes; the encoder
blocks' ``LayerNorm_0`` / ``LayerNorm_1`` / ``Dense_0`` / ``Dense_1`` map to
``ln1`` / ``ln2`` / ``mlp_in`` / ``mlp_out``; the head's ``LayerNorm_0`` /
``Dense_0`` to ``ln`` / ``fc``.
"""

from __future__ import annotations

import numpy as np
import torch


from adapt_tpu_torch.ops.quantize import QuantizedTensor, dequantize

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def quantized_leaf(values, scales, shape, dtype) -> QuantizedTensor:
    """The numpy fields of a JAX ``QuantizedTensor`` -> the port's (CPU
    tensors; ``dtype`` is the logical dtype's name or numpy dtype)."""
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name not in _DTYPES:
        raise ValueError(f"quantized leaf dtype {name!r} is not a float type")
    return QuantizedTensor(
        torch.from_numpy(np.array(values, dtype=np.int8, copy=True)),
        torch.from_numpy(np.array(scales, dtype=np.float32, copy=True)),
        tuple(int(d) for d in shape), _DTYPES[name],
    )


def _arr(x) -> np.ndarray:
    """A leaf as an f32 numpy array; a quantized 4-tuple dequantizes."""
    if isinstance(x, tuple) and len(x) == 4:
        return dequantize(quantized_leaf(*x)).to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(_arr(x), dtype=np.float32, copy=True))


def _dense(out: dict, prefix: str, p: dict) -> None:
    kernel = _arr(p["kernel"])
    out[f"{prefix}.weight"] = _t(kernel.reshape(kernel.shape[0], -1).T)
    out[f"{prefix}.bias"] = _t(_arr(p["bias"]).reshape(-1))


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
        _norm(sd, f"{name}.ln1", p["ln1"])
        _norm(sd, f"{name}.ln2", p["ln2"])
        if "moe" in p:
            # Expert-stacked, in the JAX layout as it is.
            for leaf in ("gate", "w1", "b1", "w2", "b2"):
                sd[f"{name}.moe.{leaf}"] = _t(p["moe"][leaf])
        else:
            _dense(sd, f"{name}.mlp_in", p["mlp_in"])
            _dense(sd, f"{name}.mlp_out", p["mlp_out"])
        attn = p["attn"]
        for proj in ("qkv", "q", "kv", "out"):
            if proj in attn:
                _dense(sd, f"{name}.attn.{proj}", attn[proj])
    return sd


def shard_state_dict(sd: dict, mesh, rules) -> dict:
    """A converted ``state_dict`` cut onto ``mesh`` by ``rules(name,
    ndim)`` (``parallel.sharding.lm_tp_rules`` / ``vit_tp_rules``, or
    ``parallel.expert.expert_shardings``' specs): name -> ``Shards``, piece
    ``i`` on mesh position ``i``'s device. The pieces of a JAX leaf placed
    by the same rules are its ``addressable_shards``, converted leaf by
    leaf; ``models.transformer_lm.shard_lm`` builds the sharded model from
    them."""
    from adapt_tpu_torch.parallel.sharding import Sharding

    return {name: Sharding(mesh, rules(name, t.ndim)).shard(t)
            for name, t in sd.items()}


def vit_from_flax(variables) -> dict[str, torch.Tensor]:
    """flax ViT variables -> the port's ViT ``state_dict`` (f32 CPU
    tensors)."""
    sd: dict[str, torch.Tensor] = {}
    pe = variables["patch_embed"]["params"]
    conv = pe["Conv_0"]
    sd["layers.patch_embed.weight"] = _t(
        np.transpose(_arr(conv["kernel"]), (3, 2, 0, 1)))
    sd["layers.patch_embed.bias"] = _t(conv["bias"])
    sd["layers.patch_embed.cls"] = _t(pe["cls"])
    sd["layers.patch_embed.pos_embed"] = _t(pe["pos_embed"])
    blocks = sorted(
        (k for k in variables if k.startswith("encoder_block_")),
        key=lambda k: int(k.rsplit("_", 1)[1]),
    )
    for name in blocks:
        p = variables[name]["params"]
        pre = f"layers.{name}"
        _norm(sd, f"{pre}.ln1", p["LayerNorm_0"])
        _norm(sd, f"{pre}.ln2", p["LayerNorm_1"])
        _dense(sd, f"{pre}.mlp_in", p["Dense_0"])
        _dense(sd, f"{pre}.mlp_out", p["Dense_1"])
        _dense(sd, f"{pre}.attn.qkv", p["attn"]["qkv"])
        _dense(sd, f"{pre}.attn.out", p["attn"]["out"])
    head = variables["head"]["params"]
    _norm(sd, "layers.head.ln", head["LayerNorm_0"])
    _dense(sd, "layers.head.fc", head["Dense_0"])
    return sd


def _conv_kernel(k) -> torch.Tensor:
    return _t(np.transpose(_arr(k), (3, 2, 0, 1)))


def _convbn(out: dict, prefix: str, p: dict, stats: dict) -> None:
    out[f"{prefix}.weight"] = _conv_kernel(p["Conv_0"]["kernel"])
    _norm(out, prefix, p["BatchNorm_0"])
    out[f"{prefix}.mean"] = _t(stats["BatchNorm_0"]["mean"])
    out[f"{prefix}.var"] = _t(stats["BatchNorm_0"]["var"])


def _convbns(p: dict) -> list[str]:
    return sorted((k for k in p if k.startswith("ConvBN_")),
                  key=lambda k: int(k.rsplit("_", 1)[1]))


def cnn_from_flax(variables) -> dict[str, torch.Tensor]:
    """flax ResNet / EfficientNet variables -> the port's CNN
    ``state_dict`` (f32 CPU tensors, BatchNorm statistics included)."""
    sd: dict[str, torch.Tensor] = {}
    for node, v in variables.items():
        p, stats = v.get("params", {}), v.get("batch_stats", {})
        if not p:
            continue  # a merge node
        pre = f"layers.{node}"
        convs = _convbns(p)
        if "Conv_0" in p:  # the node is a ConvBN
            _convbn(sd, pre, p, stats)
            continue
        if "Dense_0" in p:  # ClassifierHead
            _dense(sd, f"{pre}.fc", p["Dense_0"])
            continue
        if "SqueezeExcite_0" in p:  # MBConvBranch
            roles = (["expand"] if len(convs) == 3 else []) + [
                "depthwise", "project"]
            se = p["SqueezeExcite_0"]
            for name, conv in (("reduce", "Conv_0"), ("expand", "Conv_1")):
                sd[f"{pre}.se.{name}_weight"] = _conv_kernel(
                    se[conv]["kernel"])
                sd[f"{pre}.se.{name}_bias"] = _t(se[conv]["bias"])
        elif len(convs) == 3:  # BottleneckBranch
            roles = ["conv0", "conv1", "conv2"]
        elif len(convs) == 1:  # stem, Projection
            roles = ["conv"]
        else:
            raise ValueError(f"node {node!r}: unknown CNN module layout "
                             f"{sorted(p)}")
        for role, conv in zip(roles, convs, strict=True):
            _convbn(sd, f"{pre}.{role}", p[conv], stats[conv])
    return sd
