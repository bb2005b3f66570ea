"""Run observability: the train step's health metrics and their host-side
detectors (``health.py``)."""
