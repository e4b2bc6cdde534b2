"""The Point-E family's entry points: image -> point cloud, text -> point cloud and point
cloud -> mesh, each a ``main(argv=None, device="cuda")`` and ``python -m`` script."""
