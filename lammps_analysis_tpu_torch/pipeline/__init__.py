"""Host -> device streaming."""
