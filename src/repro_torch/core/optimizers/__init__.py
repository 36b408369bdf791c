"""Greedy engines, gain backends and the spec front door of the port."""
