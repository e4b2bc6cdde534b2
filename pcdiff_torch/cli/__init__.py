"""Command-line drivers of the port: ``python -m pcdiff_torch.cli.train``, ``.sample``
and ``.evaluate``, each with ``--config``, ``--device`` (``cuda`` by default) and
``key.path=value`` overrides; ``.evaluate_pfid`` and ``.evaluate_pis`` (P-FID and P-IS
of npz sample batches) and ``.downsample`` (FPS of an H5 dataset), each with the JAX
package's arguments and ``--device``."""
