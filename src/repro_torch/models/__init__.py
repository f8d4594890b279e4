"""Runnable models of the port (NHWC, nested-dict params)."""
