"""Deploy lifecycle of the port: training runs, the query server and its
micro-batcher."""
