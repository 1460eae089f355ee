from mg_ic_code_tpu_torch.grid.boxes import Box
from mg_ic_code_tpu_torch.grid.geometry import BCSpec, HierarchyGeom

__all__ = ["Box", "BCSpec", "HierarchyGeom"]
