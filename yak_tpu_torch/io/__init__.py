"""Host-side ingest and table I/O (numpy): FASTA/Q reading, chunk
packing, and the `.yak` file format."""
