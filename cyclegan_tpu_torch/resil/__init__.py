"""Resilience of a training run (the single-process part of the JAX
package's ``resil/``)."""
