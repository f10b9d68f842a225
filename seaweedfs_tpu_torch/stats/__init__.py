"""Cluster telemetry plane: hot-key sketches, snapshot aggregation,
and SLO burn-rate evaluation (see ARCHITECTURE.md "Observability").

The port's copy of seaweedfs_tpu/stats/__init__.py, the same code; it imports
nothing of that package.
"""
