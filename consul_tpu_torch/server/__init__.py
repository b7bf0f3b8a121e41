"""Host-side server pieces the port needs (copies of the reference's
jax-free modules; see each module)."""
