"""Connector layer: the plugin SPI plus built-in connectors.

Analogue of trino-spi's connector surface (spi/connector/ ~100
interfaces, spi/Plugin.java:35 — SURVEY.md §2.12). The port carries the tpch
and tpcds generators, the memory connector (read and write sides), the
file connector (CSV, JSON-lines and Parquet tables: `file.py`, with its
own parquet codec `parquet_format.py`) and the blackhole sink.
"""

from trino_tpu_torch.connectors.spi import (  # noqa: F401
    CatalogManager,
    ColumnMetadata,
    Connector,
    ConnectorMetadata,
    ConnectorPageSink,
    ConnectorPageSource,
    ConnectorSplitManager,
    Split,
    TableHandle,
    TableMetadata,
)
