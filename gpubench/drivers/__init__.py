"""The window drivers, one per kind of traffic; a mix names its own."""
