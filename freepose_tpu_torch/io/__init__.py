"""Static numpy IO: meshes, RLE masks, proposal JSON, BOP CSV."""
