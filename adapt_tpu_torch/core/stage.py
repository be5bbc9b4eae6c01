"""Pipeline stages bound to a device.

Counterpart of ``adapt_tpu/core/stage.py``. A stage there is a jitted XLA
program plus device-resident variables; here it is the stage's own module
(``PartitionPlan.build_stage``: the stage's node modules built on the
device) holding the stage's weights. Re-binding a stage to another device
moves its weights and builds nothing.

The JAX package's ``donate_activations`` (let XLA reuse the input buffer)
has no torch meaning: eager ops allocate their outputs and free a stage's
input when the caller drops it, so the port leaves the option out.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch

from adapt_tpu_torch.graph.partition import (
    PartitionPlan,
    StageModule,
    StageSpec,
    StageState,
)


@dataclasses.dataclass
class CompiledStage:
    """A stage bound to a device: its module, with the weights resident on
    ``device``. Calls run without autograd (serving is inference)."""

    spec: StageSpec
    module: StageModule
    device: torch.device

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.module(x.to(self.device))

    def rebind(self, device, host_state: StageState) -> "CompiledStage":
        """Move this stage to ``device`` (failure recovery, late binding):
        its module's storage is allocated there and ``host_state`` copied
        in. Only weights move; no module is built. The stage leaves its old
        device."""
        device = torch.device(device)
        self.module.to_empty(device=device).load_stage_state(host_state)
        self.device = device
        return self


def compile_stages(
    plan: PartitionPlan,
    variables=None,
    devices: Sequence[torch.device] = (),
) -> list[CompiledStage]:
    """One :class:`CompiledStage` per plan stage, round-robin over
    ``devices``, loaded from ``variables`` (``{node: state dict}``; None
    is the graph's own weights)."""
    if not devices:
        raise ValueError("no devices")
    out = []
    for spec, svars in zip(plan.stages, plan.extract_variables(variables)):
        device = torch.device(devices[spec.index % len(devices)])
        module = plan.build_stage(spec, device).load_stage_state(svars)
        out.append(CompiledStage(spec=spec, module=module.eval(),
                                 device=device))
    return out
