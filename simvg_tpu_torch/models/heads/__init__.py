from .tgqs_head import TGQSHeadConfig, TGQSKDDETRHead

__all__ = ["TGQSHeadConfig", "TGQSKDDETRHead"]
