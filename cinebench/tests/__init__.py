"""The benchmark's own tests (``python -m pytest cinebench/tests``)."""
