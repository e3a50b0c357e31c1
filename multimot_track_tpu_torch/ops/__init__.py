"""Wire codec, patch ZNCC and the JAX-exact linear resize."""
