"""RGL core: the retrieval pipeline (index → seeds → subgraph → filter →
tokenize).  Import the stage modules by path."""
