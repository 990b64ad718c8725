"""Fault tolerance around the train step (``fault``)."""
