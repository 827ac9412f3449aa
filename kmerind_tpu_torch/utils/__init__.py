"""Phase timers."""
