"""Command-line framework mirroring the reference's ``mash <command>`` CLI."""
