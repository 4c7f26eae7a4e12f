"""Multi-GPU training and rendering over ``torch.distributed`` process
groups: one process per GPU (``data_parallel``, ``tile_parallel``).

JAX's ``parallel/mesh.py`` has no counterpart: a process group takes the
place of its device mesh, and the caller sets it up
(``torch.distributed.init_process_group``).
"""
