"""The port's runnable scripts: the quality gate, the quality baseline and
the pipeline drivers (counterparts of the repository's ``scripts/``)."""
