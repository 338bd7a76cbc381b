"""Row-sharded tables and the sharded steps over ``torch.distributed``.

Counterpart of ``ml_function_tpu/parallel/``. One process (rank) is one
coordinate of the ``(data, model)`` mesh: the batch is split over ``data``,
the embedding tables' rows over ``model``. The modules import nothing here,
so that ``ops`` can read the context without an import cycle.
"""
