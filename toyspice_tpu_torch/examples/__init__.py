"""Programmatic-API examples of the port (examples/ of the JAX package):
``rr``, ``diode1``, ``diode2``, ``bjt`` and ``montecarlo``, each run as
``python -m toyspice_tpu_torch.examples.<name>``.  They run on the card
unless ``TOYSPICE_PLATFORM=cpu``."""
