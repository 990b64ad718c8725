"""Entry points of the port: the prefill and serve step builders
(``steps``), the serving loop (``serve``), and the summaries of a
design-space sweep (``analysis``)."""
