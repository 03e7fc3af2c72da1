"""Hand-written CUDA kernels and their plain PyTorch versions.

Each wrapper launches its kernel for CUDA tensors (or raises) and runs its
plain version for CPU tensors; ``.launches`` on the wrapper counts kernel
launches, read and reset through ``launch_counts`` / ``reset_launch_counts``.
"""

from realtime_fraud_detection_tpu_torch.ops.attention import (
    attention_reference,
    flash_attention,
)
from realtime_fraud_detection_tpu_torch.ops.dequant_matmul import (
    dequant_matmul,
    dequant_matmul_reference,
    dequant_rows,
    dequant_rows_reference,
)
from realtime_fraud_detection_tpu_torch.ops.epilogue import (
    epilogue_matrix,
    epilogue_matrix_reference,
    epilogue_packed,
    epilogue_packed_reference,
    epilogue_reference,
    fused_epilogue,
)
from realtime_fraud_detection_tpu_torch.ops.megakernel import (
    fused_megakernel,
    fused_megakernel_packed,
    mega_launch_accounting,
    mega_plan,
    megakernel_reference,
)

KERNEL_WRAPPERS = {
    "epilogue": epilogue_packed,
    "flash_attention": flash_attention,
    "dequant_matmul": dequant_matmul,
    "dequant_rows": dequant_rows,
    "megakernel": fused_megakernel,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "KERNEL_WRAPPERS", "attention_reference", "dequant_matmul",
    "dequant_matmul_reference", "dequant_rows", "dequant_rows_reference",
    "epilogue_matrix", "epilogue_matrix_reference", "epilogue_packed",
    "epilogue_packed_reference", "epilogue_reference",
    "flash_attention", "fused_epilogue", "fused_megakernel",
    "fused_megakernel_packed",
    "launch_counts", "mega_launch_accounting", "mega_plan",
    "megakernel_reference", "reset_launch_counts",
]
