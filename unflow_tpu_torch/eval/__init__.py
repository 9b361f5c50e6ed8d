"""Inference, evaluation metrics and flow visualization of the port."""
