"""Training on one device: the loss, the Adam step, the windowed corpus and
the epoch loop (counterpart of ``nanoreviser_tpu/train``)."""
