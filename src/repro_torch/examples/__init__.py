"""Runnable examples of the port, each a module with a ``main()``::

    python -m repro_torch.examples.quickstart [--device cuda|cpu]
    python -m repro_torch.examples.gnn_inference [dataset] [scale] [--device cuda|cpu]

(with ``src`` on ``PYTHONPATH``).  Importing a module runs nothing.
"""
