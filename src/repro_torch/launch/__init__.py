"""Entry points of the port: the prefill and serve step builders
(``steps``) and the serving loop (``serve``)."""
