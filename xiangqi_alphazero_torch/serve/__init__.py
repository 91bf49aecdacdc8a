"""Serving: predictor, coalescing session searcher and the HTTP API."""
