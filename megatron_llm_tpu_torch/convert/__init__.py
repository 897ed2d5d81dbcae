"""Weight converters."""
