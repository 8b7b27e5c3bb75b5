"""The yardstick: published peaks and each cell's necessary work."""
