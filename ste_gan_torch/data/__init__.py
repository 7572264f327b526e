"""The port's data pipeline: its own copies of the JAX package's corpus
readers, collate and loaders, plus the corpus resident on the card."""
