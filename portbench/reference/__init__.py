"""Plain NumPy reference of the solves the benchmark times.

Nothing here imports the program under test, JAX or the JAX package: the
reference derives every operator again from the configuration file and
judges the program's outputs by their meaning (objective value, gradient,
total variation, admissibility, and the trust-region step that certifies
stationarity).  Each problem lives in a module of its own, found by the
name a configuration file gives under ``"reference"``.
"""
