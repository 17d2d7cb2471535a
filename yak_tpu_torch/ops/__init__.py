"""Device operations of the port: keys, encoding, hash, extraction,
the plain sort-merge engine, the merge-reduce kernel and the count
fold."""
