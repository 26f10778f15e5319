"""One module per architecture the port serves; each exports config() and
smoke(). Copies of the JAX package's ``configs/`` for the families the port
runs (dense, ssm, hybrid); ``smoke()`` returns a reduced same-family config
for CPU tests."""
