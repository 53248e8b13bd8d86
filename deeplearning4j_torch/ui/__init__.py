"""Observability: StatsListener → StatsStorage → static report + live UIServer
(reference deeplearning4j-ui-parent). Port of `deeplearning4j_tpu/ui/`: the
same names, routes, HTML and JSON; the statistics are computed on the device
(ui/stats.py)."""
from .components import (ChartHistogram, ChartHorizontalBar, ChartLine,
                         ChartScatter, ComponentDiv, ComponentTable,
                         ComponentText, component_from_json,
                         component_to_json, render_component)
from .convolutional import ConvolutionalIterationListener
from .remote import RemoteStatsStorageRouter, StatsReceiverServer
from .report import export_json, render_html, render_html_report
from .server import UIServer
from .stats import (FileStatsStorage, InMemoryStatsStorage, StatsListener,
                    StatsStorage, StatsUpdateConfiguration)
