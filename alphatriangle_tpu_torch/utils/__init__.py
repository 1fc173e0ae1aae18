"""Host-side helpers: the SumTree mirror, batch types and the one-copy
device-to-host fetch."""
