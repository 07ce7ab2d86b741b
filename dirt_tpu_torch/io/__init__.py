"""Asset IO of dirt_tpu_torch (counterpart of ``dirt_tpu/io``)."""

from dirt_tpu_torch.io.objloader import ObjMesh, load_obj

__all__ = ["ObjMesh", "load_obj"]
