"""Data-parallel encode over several devices (``sharded``) and several
processes (``multihost``)."""
from zzflate_tpu_torch.parallel.sharded import compress_sharded, make_mesh

__all__ = ["compress_sharded", "make_mesh"]
