"""Command-line front door of the port."""
