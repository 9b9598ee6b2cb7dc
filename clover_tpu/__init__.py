"""clover_tpu — a block-scaled quantized linear-algebra engine in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference AVX2 library (astojanov/Clover): 4/8-bit block-scaled
stochastic-quantized formats plus fp16/fp32, quantize / restore / dot /
scaleAndAdd / transpose / top-K threshold, the fused requantizing MVM (a
Triton kernel on GPUs), GD and IHT solvers, and mesh-sharded multi-device
execution with psum'd partials.
"""

from .formats import (
    BLOCK, PAD, QMat4, QMat8, QMat16, QMat32, QVec4, QVec8, QVec16, QVec32,
    pack_nibbles, pad_to, unpack_nibbles, zeros_vector,
)
from .ops import (
    dot, gemm_f32, mvm, mvm_axpy, mvm_batched, mvm_f32, mvm_sparse, quantize,
    quantize_mat, quantize_vec, restore, restore_mat, restore_vec,
    scale_and_add, threshold, transpose,
)

__version__ = "0.1.0"

__all__ = [
    "BLOCK", "PAD",
    "QVec4", "QVec8", "QVec16", "QVec32",
    "QMat4", "QMat8", "QMat16", "QMat32",
    "pack_nibbles", "unpack_nibbles", "pad_to", "zeros_vector",
    "quantize", "quantize_vec", "quantize_mat",
    "restore", "restore_vec", "restore_mat",
    "dot", "scale_and_add", "mvm", "mvm_axpy", "mvm_f32", "threshold",
    "transpose",
    "mvm_sparse", "mvm_batched", "gemm_f32",
]
