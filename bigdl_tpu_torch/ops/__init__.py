"""Kernel wrappers of the port: each op holds its plain PyTorch version
and the wrapper of its hand-written CUDA kernel (``csrc/``).  A CUDA
tensor launches the kernel or raises; a CPU tensor runs the plain
version."""

from typing import Callable, Dict


def kernel_wrappers() -> Dict[str, Callable]:
    """Every kernel wrapper of the port, by kernel name."""
    from bigdl_tpu_torch.ops import attention, lrn, pool, pooling

    return {"cross_map_lrn_fwd": lrn.cross_map_lrn_forward,
            "cross_map_lrn_bwd": lrn.cross_map_lrn_backward,
            "avg_pool_fwd": pool.avg_pool_forward,
            "avg_pool_bwd": pool.avg_pool_backward,
            "flash_fwd": attention.flash_fwd,
            "flash_dq": attention.flash_dq,
            "flash_dkv": attention.flash_dkv,
            "maxpool_fwd": pool.maxpool_forward,
            "maxpool_tie_bwd": pool.maxpool_tie_split_backward,
            "maxpool_argmax_bwd": pooling.maxpool_argmax_backward}


def kernel_launches() -> Dict[str, int]:
    """Each wrapper's launch counter, by kernel name."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_kernel_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
