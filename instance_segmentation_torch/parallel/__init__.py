"""Data parallelism over ``torch.distributed``: process-group set-up and the
batch split (``multihost``).

The JAX package declares a ``("data", "spatial")`` mesh and lets GSPMD place
the work. The port runs one process per rank with ``DistributedDataParallel``
and the sync batch norm of ``models/layers.py``, so its only axis is the
data axis, as wide as the process group. The spatial axis (the image W axis
sharded across devices) is not ported.
"""
