"""Training on one device or data-parallel over N processes: the loss, the
Adam step, the windowed corpus and the epoch loop (counterpart of
``nanoreviser_tpu/train``)."""
