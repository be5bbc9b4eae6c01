"""The port's boundary: ``adapt_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor the JAX package, and entry points never quietly run on
the CPU when no card is present."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "adapt_tpu")


def _port_files():
    return sorted((ROOT / "adapt_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"
    ]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    for want in (
        "chip_smoke.py",
        "adapt_tpu_torch/ops/attention.py",
        "adapt_tpu_torch/ops/decode_attention.py",
        "adapt_tpu_torch/models/transformer_lm.py",
        "adapt_tpu_torch/runtime/continuous.py",
        "adapt_tpu_torch/convert.py",
    ):
        assert want in names


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix()
)
def test_no_jax_imports(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.name} imports {bad}"


def test_forbidden_rule_keeps_the_port_itself():
    assert _forbidden("adapt_tpu.models")
    assert _forbidden("jax.numpy")
    assert not _forbidden("adapt_tpu_torch.ops")


def test_entry_points_refuse_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card rule does not apply")
    from adapt_tpu_torch import resolve_device
    from adapt_tpu_torch.models.transformer_lm import lm_tiny, transformer_lm

    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_tiny()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer_lm(61, 64, 2, 8, 128)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_refuse_cpu_tensors():
    from adapt_tpu_torch.ops.attention import flash_attn_fwd
    from adapt_tpu_torch.ops.decode_attention import decode_attn

    q = torch.zeros(1, 1, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn(q[:, :, :1], q, q, 0)
    assert flash_attn_fwd.launches == 0 and decode_attn.launches == 0
