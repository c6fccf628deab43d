"""Host-side file formats: images and PLY point clouds (numpy, no torch)."""
