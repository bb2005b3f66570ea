"""Domain pairs: the registry of domain-pair specs (``registry.py``) and
transfer onboarding from a trained parent run (``transfer.py``)."""
