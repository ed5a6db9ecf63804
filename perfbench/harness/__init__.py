"""The benchmark's runners and its yardstick: traffic, the window, the
trace's reduction, operations and bytes from shapes, the check."""
