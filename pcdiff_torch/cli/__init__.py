"""Command-line drivers of the port: ``python -m pcdiff_torch.cli.train``, ``.sample``
and ``.evaluate``, each with ``--config``, ``--device`` (``cuda`` by default) and
``key.path=value`` overrides."""
