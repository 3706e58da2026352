"""Command line: the ``serve`` subcommand and its HTTP server."""
