"""Parallelism over ``torch.distributed``: process-group set-up and the
batch split (``multihost``), the (data, spatial) mesh (``mesh``) and the
collectives of its spatial axis (``spatial``).

The JAX package declares a ``("data", "spatial")`` mesh and lets GSPMD place
the work. The port runs one process per rank. Training is data-parallel
(``DistributedDataParallel`` and the sync batch norm of
``models/layers.py``), as in the JAX package; the eval forward and the
decode also take the spatial axis, the image W axis split over ranks.
"""
