"""Distribution layer: logical-axis sharding rules over a device mesh (the
port of ``repro.sharding``, plain Python).

Mesh axes (see :mod:`repro_torch.launch.mesh`): ``("pod", "data",
"model")`` for the multi-pod mesh, ``("data", "model")`` for one pod.  A
:class:`ShardingPolicy` maps *logical* axis names (``"embed"``,
``"heads"``, ``"mlp"``, ``"experts"``, ``"batch"``, ...) to mesh axes;
:func:`repro_torch.models.build_model` reads the policy's rules to decide
which of a rank's parameters are slices (``Model.param_placements``).
"""

from .axes import AxisRules, entry_axes, fit_sharding, logical_spec
from .policy import (POLICIES, ShardingPolicy, get_policy, inference_2d,
                     inference_prefill_opt, inference_seqkv, inference_tp,
                     train_2d)

__all__ = [
    "AxisRules", "entry_axes", "fit_sharding", "logical_spec",
    "POLICIES", "ShardingPolicy", "get_policy", "inference_2d",
    "inference_prefill_opt", "inference_seqkv", "inference_tp", "train_2d",
]
