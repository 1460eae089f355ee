"""The sharded solve: device mesh (mesh), halo exchange around the halo
kernels (halo), process bootstrap and tile streaming (distributed)."""
