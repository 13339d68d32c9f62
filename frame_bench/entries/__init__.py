"""The entries a traffic file can name, one module each: ``<entry>.py``
holds ``Entry``, a ``workload.Workload`` that drives the port's entry
point for the cell's frames."""
