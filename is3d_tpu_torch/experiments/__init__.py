"""Counterparts of the JAX package's Pallas experiments (experiments/),
each a hand-written CUDA kernel beside its plain torch version, with a
``main()`` that times the kernel on the card at the experiment's shape."""
