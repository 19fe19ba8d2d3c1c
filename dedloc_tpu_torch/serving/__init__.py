"""The serving plane's records, copied for the trainer's metrics validators.

Only ``records`` is copied so far (``collaborative/metrics.py`` reads
``ExpertRecord`` lazily); the expert host, router and admission come with
the serving slice.
"""
