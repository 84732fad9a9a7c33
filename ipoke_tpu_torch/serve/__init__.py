"""Serving: dynamic request batching over the port's ``forward_sample``
(counterpart of ``ipoke_tpu/serve``).  ``batcher.py`` is the core,
``server.py`` the HTTP front end and ``loadtest.py`` its load-test client.
"""
