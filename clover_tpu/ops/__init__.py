"""Quantized linear-algebra ops (plain XLA; on a GPU the MVM family runs
the Triton kernel in clover_tpu.kernels for the shapes it takes)."""

from .access import (
    mat_get, random_floats, random_integers, vec_get, vec_get_code,
    vec_set_code,
)
from .axpy import scale_and_add
from .dot import dot
from .gemm import gemm_f32, mvm_batched
from .mvm import mvm, mvm_axpy, mvm_f32
from .quantize import (
    quantize, quantize_mat, quantize_vec, restore, restore_mat, restore_vec,
)
from .sparse import mvm_sparse
from .threshold import threshold
from .transpose import transpose

__all__ = [
    "quantize", "quantize_vec", "quantize_mat",
    "restore", "restore_vec", "restore_mat",
    "dot", "scale_and_add", "mvm", "mvm_axpy", "mvm_f32", "threshold",
    "transpose",
    "mvm_sparse", "mvm_batched", "gemm_f32",
    "vec_get", "vec_get_code", "vec_set_code", "mat_get",
    "random_floats", "random_integers",
]
