"""One module per architecture of ``models.registry.ARCH_IDS``; each
exports config() and smoke(). Copies of the JAX package's ``configs/``;
``smoke()`` returns a reduced same-family config for CPU tests."""
