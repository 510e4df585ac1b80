"""Runnable examples of the port (``python -m repro_torch.examples.<name>``),
twins of the repository's ``examples/`` scripts; each runs on the card
unless ``--device cpu`` asks for the host."""
