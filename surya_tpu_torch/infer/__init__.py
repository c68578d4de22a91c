"""Serving tier: fixed-batch Predictor and the HTTP server."""
