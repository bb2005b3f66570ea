"""Bucketed inference engine."""
