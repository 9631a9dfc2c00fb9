"""The SmartConf-governed trainer."""
