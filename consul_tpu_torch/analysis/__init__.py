"""Run-time guards of the port (counterpart of the reference's
``consul_tpu/analysis/guards.py``): :mod:`guards`."""
