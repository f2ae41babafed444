"""Multi-device execution: tensor parallelism, ring attention and the
(cfg, frames)-sharded video step over `core/mesh.py`'s meshes."""
