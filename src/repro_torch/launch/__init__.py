"""Entry points of the port: the train, prefill and serve step builders
(``steps``), the training driver (``train``), the serving loop
(``serve``), the shape table (``shapes``), and the summaries of a
design-space sweep (``analysis``)."""
