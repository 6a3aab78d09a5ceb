"""Training-side utilities of the port: checkpointing
(``repro.train``)."""
