"""Architecture by value: a LayerGraph's STRUCTURE to and from JSON.

Counterpart of ``adapt_tpu/graph/spec.py``. A spec is, per node, its name,
its input edges and its module: the class's import path and the arguments
it was constructed with (``NodeModule.spec_args``), or the name of a
registered merge op. No weights: those travel as state dicts.

What does NOT travel is code. Classes are imported from the installed
package on the rebuilding side, and only from under
:data:`ALLOWED_MODULE_ROOTS` (matched exactly or at a ``.`` boundary, so a
sibling package ``adapt_tpu_torchx`` is refused), and the object imported
must be an ``nn.Module`` class: a spec cannot import or call anything
else. Argument values are data only (no pickles): dtypes travel by name.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from adapt_tpu_torch import resolve_device
from adapt_tpu_torch.graph.ir import Lambda, LayerGraph

#: Merge-op vocabulary for :class:`Lambda` nodes (the Keras ``Add`` /
#: ``Concatenate`` analogs). NHWC at every node boundary, so ``concat``
#: joins the last (channel) axis, as in the JAX package.
LAMBDA_REGISTRY: dict[str, Any] = {
    "add": lambda a, b: a + b,
    "add_relu": lambda shortcut, branch: F.relu(shortcut + branch),
    "concat": lambda *xs: torch.cat(xs, dim=-1),
    "identity": lambda x: x,
}

#: Only these roots may be imported while rebuilding a spec.
ALLOWED_MODULE_ROOTS = ("adapt_tpu_torch.", "torch.nn")

_DTYPES = {str(d).removeprefix("torch."): d for d in (
    torch.float32, torch.float16, torch.bfloat16, torch.float64)}


def _under_allowed_roots(path: str) -> bool:
    """True when ``path`` (a dotted module.Class path) is exactly an
    allowed root or lives under one at a ``.`` boundary."""
    for root in ALLOWED_MODULE_ROOTS:
        if root.endswith("."):
            if path.startswith(root):
                return True
        elif path == root or path.startswith(root + "."):
            return True
    return False


def registered_lambda(name: str) -> Lambda:
    """A serializable merge op: the Lambda carries the REGISTRY's function
    object, which serialization checks by identity."""
    try:
        return Lambda(LAMBDA_REGISTRY[name], name)
    except KeyError:
        raise KeyError(
            f"no registered Lambda {name!r}; known: "
            f"{sorted(LAMBDA_REGISTRY)}"
        ) from None


def _encode_value(v: Any) -> Any:
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (tuple, list)):
        return {"__seq__": [_encode_value(x) for x in v],
                "tuple": isinstance(v, tuple)}
    if isinstance(v, dict):
        return {"__map__": {k: _encode_value(x) for k, x in v.items()}}
    if isinstance(v, torch.dtype):
        return {"__dtype__": str(v).removeprefix("torch.")}
    raise TypeError(
        f"cannot serialize module argument {v!r} (architecture-by-value "
        "carries data, not code)"
    )


def _decode_value(v: Any) -> Any:
    if isinstance(v, dict):
        if "__seq__" in v:
            seq = [_decode_value(x) for x in v["__seq__"]]
            return tuple(seq) if v.get("tuple") else seq
        if "__map__" in v:
            return {k: _decode_value(x) for k, x in v["__map__"].items()}
        if "__dtype__" in v:
            try:
                return _DTYPES[v["__dtype__"]]
            except KeyError:
                raise ValueError(
                    f"unknown dtype {v['__dtype__']!r} in graph spec"
                ) from None
    return v


def _module_to_spec(module: nn.Module) -> dict:
    if isinstance(module, Lambda):
        if LAMBDA_REGISTRY.get(module.name) is not module._fn:
            # Name-only matching would let a custom op wearing a registry
            # name be replaced by the registry op on the rebuilding side.
            raise TypeError(
                f"Lambda {module.name!r} does not carry the "
                "spec.LAMBDA_REGISTRY function of that name; build merge "
                "ops with spec.registered_lambda to ship them by value"
            )
        return {"kind": "lambda", "name": module.name}
    cls = type(module)
    path = f"{cls.__module__}.{cls.__qualname__}"
    spec_args = getattr(module, "spec_args", None)
    if spec_args is None:
        raise TypeError(
            f"cannot serialize {path!r}: node modules must subclass "
            "graph.ir.NodeModule (which records their arguments) or be a "
            "registered Lambda"
        )
    if not _under_allowed_roots(path):
        raise TypeError(
            f"cannot ship {path!r} by value: module classes must live "
            f"under {ALLOWED_MODULE_ROOTS}"
        )
    if "." in cls.__qualname__:
        raise TypeError(
            f"cannot ship nested class {path!r} by value: define shipped "
            "modules at module top level"
        )
    return {"kind": "module", "type": path,
            "config": {k: _encode_value(v) for k, v in spec_args.items()}}


def _module_from_spec(spec: dict, device) -> nn.Module:
    kind = spec.get("kind")
    if kind == "lambda":
        name = spec["name"]
        try:
            return Lambda(LAMBDA_REGISTRY[name], name)
        except KeyError:
            raise ValueError(f"unknown Lambda {name!r} in graph spec") from None
    if kind != "module":
        raise ValueError(f"unknown module kind {kind!r} in graph spec")
    path = spec["type"]
    if not _under_allowed_roots(path):
        raise ValueError(
            f"refusing to import {path!r}: graph specs may only name "
            f"classes under {ALLOWED_MODULE_ROOTS}"
        )
    mod_path, _, clsname = path.rpartition(".")
    obj: Any = getattr(importlib.import_module(mod_path), clsname)
    if not (isinstance(obj, type) and issubclass(obj, nn.Module)):
        raise ValueError(
            f"{path!r} is not an nn.Module class; refusing to call it"
        )
    config = {k: _decode_value(v) for k, v in spec["config"].items()}
    if "device" in inspect.signature(obj).parameters:
        config["device"] = device
    return obj(**config)


def graph_to_spec(graph: LayerGraph) -> dict:
    """JSON-serializable structure of ``graph`` (names, constructor
    arguments, edges; no weights)."""
    return {
        "name": graph.name,
        "output": graph.output,
        "nodes": [
            {"name": node.name, "inputs": list(node.inputs),
             "module": _module_to_spec(node.module)}
            for node in graph.nodes.values()
        ],
    }


def graph_from_spec(spec: dict, device=None) -> LayerGraph:
    """Rebuild the LayerGraph a spec describes on ``device`` (the CUDA card
    unless ``"cpu"`` is asked for). Its weights are uninitialised: load a
    state dict (``graph.load_state_dict``) before running it."""
    dev = resolve_device(device)
    g = LayerGraph(spec["name"])
    for node in spec["nodes"]:
        g.add(node["name"], _module_from_spec(node["module"], dev),
              tuple(node["inputs"]))
    g.set_output(spec["output"])
    return g
